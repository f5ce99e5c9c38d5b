"""Public solver facade: ``eigen_s`` / ``eigh`` (counterpart of
``eigenexa_tpu/solvers/solver.py``; reference: src/eigen_s.F:30 — scale →
reduce → solve the tridiagonal → back-transform → rescale).

``w, z, info = eigen_s(a, nvec=..., mode=...)``; ``info`` carries the
reference's in-band telemetry (src/eigen_s.F:284-295).  Modes
(benchmark/main2.f:243-258):

  'A' — eigenvalues + eigenvectors (default)
  'S' — skip the reduced solve: Z = Q·I (isolates TRD+TRBAK)
  'T' — skip the back-transform: Z = eigenvectors of T (TRD+D&C)
  'C' — skip both: Z = I (isolates TRD)

'N' and 'X' (Sturm bisection) and 'R' (stage data) are not ported yet
(ROADMAP A10) and raise ``NotImplementedError``.

The reduction is ``ops/householder.tridiagonalize`` with ``impl="auto"``:
rolled, unless ``householder.TRD_IMPL`` forces the windowed one.  The
scaled temporary is donated to it; the windowed
reduction hands that same buffer back as the reflector matrix, so the
stage holds one n×n buffer beside the caller's input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import torch

from eigenexa_tpu_torch.interop import as_tensor
from eigenexa_tpu_torch.ops.householder import tridiagonalize
from eigenexa_tpu_torch.runtime import (EigenContext, apply_precision,
                                        default_context)
from eigenexa_tpu_torch.solvers import dc
from eigenexa_tpu_torch.solvers.trbak import back_transform
from eigenexa_tpu_torch.utils.profiler import Profiler
from eigenexa_tpu_torch.utils.sync import device_sync

MODES = ("A", "N", "X", "S", "T", "C", "R")
_PORTED_MODES = ("A", "S", "T", "C")
_DC_LEAF = 32   # D&C leaf size: 8 merge levels at n = 8192


@dataclasses.dataclass
class SolveInfo:
    """Telemetry contract (a(1,1)/a(2,1) analogue, src/eigen_s.F:284-295;
    the collective time a(3,1) comes with the distributed port, ROADMAP
    A17).  `stages` holds the TRD-BLK / D&C / TRDBAK seconds and flops
    when the solve ran with profile=True."""

    flops: float = 0.0       # model flops: 4/3·n³ (TRD) + dc + 2·nvec·n²
    elapsed: float = 0.0     # wall seconds for the whole solve
    n: int = 0
    nvec: int = 0
    mode: str = "A"
    stages: dict = dataclasses.field(default_factory=dict)

    @property
    def gflops(self) -> float:
        return self.flops / self.elapsed / 1e9 if self.elapsed > 0 else 0.0

    def stage_report(self, printer=print):
        """Print the per-stage block (TRD-BLK/D&C/TRDBAK/Total lines,
        reference: src/eigen_s.F:180-276)."""
        for name, row in self.stages.items():
            g = (row["flops"] / row["seconds"] / 1e9 if row["seconds"] > 0
                 else 0.0)
            printer(f"  {name:8s} {row['seconds']:10.4f} s "
                    f"{g:10.2f} GFLOPS")
        printer(f"  {'Total':8s} {self.elapsed:10.4f} s "
                f"{self.gflops:10.2f} GFLOPS")


def dc_flop_model(n: int, leaf: int = 2) -> float:
    """Counted flops of the batched merge tree: per level with block size
    s the eigenvector cascade does (m/2s) merges of two (s×s)·(s×2s) GEMMs
    = 4·m·s² flops; the O(m²·n_iter) secular work is not counted
    (reference under-count note, benchmark/main2.f:461-470)."""
    m = leaf
    while m < n:
        m *= 2
    total, s = 0.0, leaf
    while 2 * s <= m:
        total += 4.0 * m * s * s
        s *= 2
    return total


def flop_model(n: int, nvec: int, with_trbak: bool) -> float:
    """The reference's reported-GFLOPS flop model (TRD 4/3·n³:
    src/eigen_s.F:177; TRBAK 2·nvec·n²: src/eigen_s.F:248; D&C via
    dc_flop_model)."""
    f = 4.0 / 3.0 * n ** 3 + dc_flop_model(n)
    if with_trbak:
        f += 2.0 * nvec * n ** 2
    return f


def matrix_scaling(a: torch.Tensor):
    """Scale A into the safe range; NaN-poison on non-finite input
    (reference: eigen_scaling, src/eigen_scaling.F:59, and the NaN guard of
    src/eigen_s.F:156-160).  Returns (A·sigma, sigma), sigma a 0-d
    tensor; no host synchronization."""
    fi = torch.finfo(a.dtype)
    anrm = a.abs().amax()
    one = torch.ones_like(anrm)
    # thresholds rounded in the input dtype, as the JAX twin computes them
    smlnum = torch.full_like(anrm, fi.tiny) / fi.eps
    rmin = torch.sqrt(smlnum)
    rmax = torch.sqrt(one / smlnum)
    sigma = torch.where((anrm > 0) & (anrm < rmin), rmin / anrm,
                        torch.where(anrm > rmax, rmax / anrm, one))
    sigma = torch.where(torch.isfinite(anrm), sigma,
                        torch.full_like(anrm, float("nan")))
    return a * sigma, sigma


def _check_mode(mode: str) -> None:
    if mode in _PORTED_MODES:
        return
    if mode in MODES:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP A10)")
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _solve(a, nvec: int, mode: str, nb_f: int, nb_b: int,
           prof: Optional[Profiler]):
    """scale → TRD → D&C → TRBAK.  `a` is consumed: the caller hands it
    over without keeping a reference, so the unscaled matrix is freed
    before the reduction.  With `prof`, each stage is a timed region."""
    n = a.shape[0]
    in_dtype = a.dtype
    dev = a.device

    def stage(name, flops):
        if prof is None:
            return contextlib.nullcontext()
        return prof.region(name, flops, dev)

    with stage("TRD-BLK", 4.0 / 3.0 * n ** 3):
        a_s, sigma = matrix_scaling(a)
        del a
        trd = tridiagonalize(a_s, nb=nb_f, donate=True)
        del a_s
    if mode == "C":
        return trd.d / sigma, torch.eye(n, nvec, dtype=in_dtype, device=dev)
    if mode == "S":
        w = trd.d / sigma
        z = torch.eye(n, nvec, dtype=in_dtype, device=dev)
    else:
        with stage("D&C", dc_flop_model(n)):
            w, s = dc.solve_tridiag(trd.d, trd.e, leaf=_DC_LEAF,
                                    vec_dtype=in_dtype)
            w = w / sigma
        if mode == "T":
            return w, s[:, :nvec]
        z = s[:, :nvec].contiguous()
        del s
    with stage("TRDBAK", 2.0 * nvec * n ** 2):
        z = back_transform(z, trd.v, trd.tau, nb=nb_b, donate=True)
    return w, z


def eigen_s(a, nvec: Optional[int] = None, mode: str = "A",
            ctx: Optional[EigenContext] = None, profile: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, SolveInfo]:
    """Standard real-symmetric eigensolver (reference: src/eigen_s.F:30).

    ``a`` is a symmetric (n, n) tensor (a numpy array is moved to the
    context's device); it is not modified.  The solve runs on a's device.
    Returns (w ascending, Z (n×nvec), SolveInfo).  With an f32 input, w
    comes back in float64 (the D&C working dtype) and Z in float32.
    profile=True fills SolveInfo.stages with the TRD-BLK / D&C / TRDBAK
    split (reference: src/eigen_s.F:180-276).
    """
    ctx = ctx or default_context()
    mode = mode.upper()
    _check_mode(mode)
    apply_precision(ctx.config)
    if not isinstance(a, torch.Tensor):
        a = as_tensor(a, device=ctx.device)
    n = a.shape[0]
    nvec = n if nvec is None else min(nvec, n)
    prof = Profiler() if profile else None
    cfg = ctx.config
    t0 = time.perf_counter()
    # hand the matrix over without a lingering frame binding
    holder = [a]
    del a
    w, z = _solve(holder.pop(), nvec, mode, cfg.panel_forward,
                  cfg.panel_backward, prof)
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    stages = {} if prof is None else {
        name: {"seconds": prof.times[name],
               "flops": prof.flops.get(name, 0.0)}
        for name in prof.times}
    info = SolveInfo(flops=flop_model(n, nvec, mode in ("A", "S")),
                     elapsed=elapsed, n=n, nvec=nvec, mode=mode,
                     stages=stages)
    return w, z, info


def eigh(a, nvec: Optional[int] = None, ctx: Optional[EigenContext] = None):
    """NumPy-style convenience wrapper: returns (w, Z)."""
    w, z, _ = eigen_s(a, nvec=nvec, mode="A", ctx=ctx)
    return w, z
