"""Entry points of the port (counterpart of ``__graft_entry__.py``): a
single-device solve to hand to a caller, and a dryrun of the four
distributed drivers on a mesh of processes against the reference's
acceptance thresholds (benchmark/ev_test.f:182-204, benchmark/w_test.f:41).

    python -c "from eigenexa_tpu_torch.entry import dryrun_multichip; \\
               dryrun_multichip(4, 'gloo', 'cpu')"

runs the dryrun on four gloo ranks on the CPU; on one card, ``(1, 'nccl')``
or ``(4, 'gloo')`` with every rank on ``cuda:0``.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenexa_tpu_torch.parallel import launch
from eigenexa_tpu_torch.parallel.distributed import (distributed_eigen_gev,
                                                     distributed_eigen_h,
                                                     distributed_eigen_s,
                                                     distributed_eigen_sx,
                                                     gather_matrix)
from eigenexa_tpu_torch.parallel.mesh import factor_grid
from eigenexa_tpu_torch.runtime import EigenContext, SolverConfig
from eigenexa_tpu_torch.solvers.solver import eigen_s
from eigenexa_tpu_torch.testing import (b_orthogonality_check,
                                        eigenvalue_check,
                                        eigenvalue_check_scaled, frank,
                                        frank_spectrum, gev_residual_check,
                                        orthogonality_check,
                                        random_symmetric, residual_check)

N_ENTRY = 256


def entry(device=None):
    """(fn, args): fn(a) solves the flagship path, ``eigen_s`` mode A
    (scale → blocked Householder TRD → D&C → WY back-transform, panels of
    64 and 128), and returns (w, Z); args = (Frank n = 256 f32,) on
    `device`: the card unless the caller asks for the CPU."""
    ctx = EigenContext(device=torch.device(device or "cuda"),
                       config=SolverConfig(panel_forward=64,
                                           panel_backward=128))
    a = frank(N_ENTRY, torch.float32, ctx.device)

    def fn(a):
        w, z, _ = eigen_s(a, ctx=ctx)
        return w, z

    return fn, (a,)


def _require(leg: str, *checks) -> dict:
    """Raise unless every check passed; else their values by name."""
    for chk in checks:
        if not chk.passed:
            raise AssertionError(f"{leg}: {chk}")
    return {chk.name: chk.value for chk in checks}


def dryrun_rank(mesh, n: int = 256) -> dict:
    """The four distributed drivers on this rank's blocks of n×n problems
    (JAX ``dryrun_multichip``, __graft_entry__.py:23-121): every rank of
    the mesh calls it.  f64 on the CPU, f32 on a card.  Each leg gathers Z
    and holds it to residual < 768 and orthogonality < 8 (for GEV the
    generalized residual and B-orthogonality), and w to the w_test of the
    JAX package's ``_w_ok``: the strict √ε check at f64, the
    backward-stability-scaled one at f32, CAUTION tolerated.  Any failure
    raises.  Returns {leg: {check: value}}."""
    dev = mesh.device
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    cfg = SolverConfig(panel_forward=32, panel_backward=64)

    def w_test(leg, w, w_true):
        chk = (eigenvalue_check(w, w_true) if dtype == torch.float64
               else eigenvalue_check_scaled(w.to(dtype), w_true))
        if not (chk.passed or chk.caution):
            raise AssertionError(f"{leg} w_test: {chk}")
        return chk

    def eigvalsh(a, b=None):
        """The exact spectrum in f64 on the host (B⁻¹A's through
        Cholesky)."""
        a = a.detach().cpu().to(torch.float64 if not a.is_complex()
                                else torch.complex128)
        if b is not None:
            ell = torch.linalg.cholesky(b.detach().cpu().to(torch.float64))
            a = torch.linalg.solve_triangular(ell, a, upper=False)
            a = torch.linalg.solve_triangular(ell, a.T, upper=False)
        return torch.linalg.eigvalsh(a)

    out = {}
    # eigen_s: the distributed TRD, D&C merge tree and WY back-transform
    a = frank(n, dtype, dev)
    w, z = distributed_eigen_s(a, mesh, config=cfg)
    z = gather_matrix(z, mesh, (n, n))
    out["eigen_s"] = _require("eigen_s", residual_check(a, z, w),
                              orthogonality_check(z))
    out["eigen_s"]["w"] = w_test("eigen_s", w, frank_spectrum(n)).value

    # eigen_sx: the band-2 reduction by reflector pairs and its D&C
    a2 = random_symmetric(n, dtype, device=dev)
    w, z = distributed_eigen_sx(a2, mesh, config=cfg)
    z = gather_matrix(z, mesh, (n, n))
    out["eigen_sx"] = _require("eigen_sx", residual_check(a2, z, w),
                               orthogonality_check(z))
    out["eigen_sx"]["w"] = w_test("eigen_sx", w, eigvalsh(a2)).value

    # eigen_gev: distributed_eigen_s(B), the congruence, distributed_eigen_s
    # of A', the back-multiply
    f = np.random.default_rng(11).standard_normal((n, n)) / np.sqrt(n)
    b = torch.as_tensor(f @ f.T + np.eye(n), dtype=dtype, device=dev)
    w, z = distributed_eigen_gev(a2, b, mesh, config=cfg)
    z = gather_matrix(z, mesh, (n, n))
    out["eigen_gev"] = _require("eigen_gev", gev_residual_check(a2, b, z, w),
                                b_orthogonality_check(z, b))
    out["eigen_gev"]["w"] = w_test("eigen_gev", w, eigvalsh(a2, b)).value

    # eigen_h: native complex through the same pipeline
    rng = np.random.default_rng(7)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    ah = torch.as_tensor(0.5 * (h + h.conj().T), device=dev).to(
        dtype.to_complex())
    w, z = distributed_eigen_h(ah, mesh, config=cfg)
    z = gather_matrix(z, mesh, (n, n))
    out["eigen_h"] = _require("eigen_h", residual_check(ah, z, w),
                              orthogonality_check(z))
    out["eigen_h"]["w"] = w_test("eigen_h", w, eigvalsh(ah)).value
    return out


def dryrun_multichip(n_ranks: int, backend: str,
                     device: str = "cuda") -> list:
    """Start `n_ranks` ranks on a ``factor_grid(n_ranks)`` mesh
    (``launch.spawn``, under its backend rule: nccl a card a rank, gloo on
    the CPU or with every rank on ``cuda:0``) and run :func:`dryrun_rank`
    at n = 256 on each.  A failing check on any rank raises here.
    Returns each rank's {leg: {check: value}}."""
    return launch.spawn(dryrun_rank, factor_grid(n_ranks), backend, device)
