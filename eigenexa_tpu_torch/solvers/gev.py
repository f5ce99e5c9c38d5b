"""Generalized symmetric-definite eigensolver ``eigen_gev`` (counterpart of
``eigenexa_tpu/solvers/gev.py``; reference: src/KMATH_EIGEN_GEV.F:2,
src/KMATH_EIGEN_GEV_1.F:40-115).  The spectral reduction, as the
reference:

  1. eigen_s(B)           →  B = V_B·D_B·V_Bᵀ  (must be positive definite)
  2. F = V_B·D_B^{-1/2}    (diag_mult, KMATH_EIGEN_GEV_misc.F:49)
  3. A′ = Fᵀ·A·F, re-symmetrized
  4. eigen_s(A′)          →  A′ = Z′·W·Z′ᵀ
  5. Z = F·Z′

so that A·Z = B·Z·W with Zᵀ·B·Z = I.  A B that is not positive definite
NaN-poisons the result instead of raising (the reference aborts on
w(1) <= 0, KMATH_EIGEN_GEV_1.F:47).  The three products are plain
``torch.matmul``, as the JAX package leaves them to XLA; the two solves run
through ``eigen_s`` and its kernels.
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

import torch

from eigenexa_tpu_torch.interop import as_tensor
from eigenexa_tpu_torch.runtime import EigenContext, default_context
from eigenexa_tpu_torch.solvers.solver import SolveInfo, eigen_s, flop_model
from eigenexa_tpu_torch.utils import profiler
from eigenexa_tpu_torch.utils.profiler import Profiler
from eigenexa_tpu_torch.utils.sync import device_sync


def gev_flop_model(n: int, nvec: int, mode: str = "A") -> float:
    """Model flops of the generalized solve: the two eigen_s calls and the
    three products of the spectral reduction (eigen_s(B), Fᵀ·A, (FᵀA)·F,
    eigen_s(A′), F·Z′), the JAX package's one model."""
    f = flop_model(n, n, True) + 2 * (2.0 * n ** 3)   # eigen_s(B) + FᵀAF
    if mode.upper() == "N":
        return f + flop_model(n, 0, False)
    return f + flop_model(n, nvec, True) + 2.0 * n * n * nvec


def eigen_gev(a, b, nvec: Optional[int] = None, mode: str = "A",
              ctx: Optional[EigenContext] = None, profile: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], SolveInfo]:
    """Solve A·x = λ·B·x for symmetric A and symmetric positive definite B
    (real, f32 or f64; numpy arrays are moved to the context's device;
    neither is modified).

    Returns (w ascending float64, Z (n×nvec) B-orthonormal in A's dtype or
    None, SolveInfo).  Mode 'N' returns the eigenvalues alone (eigen_s(A′)
    in mode N, no F·Z′); other modes raise, as the reference computes
    eigenpairs only.  profile=True fills SolveInfo.stages with the seconds
    of eigen_s(B) (SOLVE-B), of F and F′AF (REDUCE), of eigen_s(A′)
    (SOLVE-A') and of F·Z′ (BACK).
    """
    ctx = ctx or default_context()
    mode = mode.upper()
    if mode not in ("A", "N"):
        raise ValueError(
            f"eigen_gev supports modes 'A' and 'N'; got {mode!r} (the "
            "reference KMATH_EIGEN_GEV.F computes eigenpairs only)")
    if not isinstance(a, torch.Tensor):
        a = as_tensor(a, device=ctx.device)
    if not isinstance(b, torch.Tensor):
        b = as_tensor(b, device=ctx.device)
    n = a.shape[0]
    nvec = n if nvec is None else min(nvec, n)
    prof = Profiler() if profile else None

    stage = functools.partial(profiler.stage, prof, device=a.device)

    t0 = time.perf_counter()
    with stage("SOLVE-B", flop_model(n, n, True)):
        wb, vb, _ = eigen_s(b, mode="A", ctx=ctx)
    with stage("REDUCE", 4.0 * n ** 3):
        # positive-definiteness guard: NaN poison (the reference aborts)
        pd_ok = wb[0] > 0
        safe_wb = torch.where(wb > 0, wb, 1.0)
        dinv_sqrt = torch.where(pd_ok, 1.0 / torch.sqrt(safe_wb),
                                float("nan")).to(a.dtype)
        f = vb * dinv_sqrt[None, :]
        del vb
        a2 = f.T @ a @ f
        a2 = 0.5 * (a2 + a2.T)   # re-symmetrize (the congruence rounds)
    with stage("SOLVE-A'", flop_model(n, 0 if mode == "N" else nvec,
                                      mode == "A")):
        if mode == "N":
            w, z2 = eigen_s(a2, mode="N", ctx=ctx)[0], None
        else:
            w, z2, _ = eigen_s(a2, nvec=nvec, mode="A", ctx=ctx)
    z = None
    if z2 is not None:
        with stage("BACK", 2.0 * n * n * nvec):
            z = f @ z2
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    stages = {} if prof is None else prof.stages()
    info = SolveInfo(flops=gev_flop_model(n, nvec, mode), elapsed=elapsed,
                     n=n, nvec=nvec, mode=mode, stages=stages)
    return w, z, info
