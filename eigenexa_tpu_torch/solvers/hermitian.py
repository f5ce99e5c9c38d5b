"""Complex Hermitian eigensolver ``eigen_h`` (counterpart of the native
complex path of ``eigenexa_tpu/solvers/hermitian.py``; reference:
src/eigen_h.F:28).

scale → the complex rolled reduction to a *real* tridiagonal T
(``ops/householder.tridiagonalize``: zlarfg reflectors with a real β,
reference eigen_hrd, src/eigen_hrd.F:1) → the real D&C on T → the real
eigenvectors cast to complex (convert_DtoZ, src/eigen_h.F:294) → the
complex WY back-transform (hrbakwy4, src/hrbakwy4.F:1) → rescale.  The
reduction's rank-2k trailing updates and every back-transform block run
through the complex entry points of the ``sub_matmul`` kernel; the windowed
reduction is real only.

The JAX package's real-pair path (``eigen_h_realpair``, ``ops/zreal.py``,
the host cluster fix) exists for a TPU backend without complex dtypes and
is not ported: the card has them (ROADMAP A13).
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

import torch

from eigenexa_tpu_torch.interop import as_tensor
from eigenexa_tpu_torch.ops.householder import tridiagonalize
from eigenexa_tpu_torch.runtime import (EigenContext, apply_precision,
                                        default_context)
from eigenexa_tpu_torch.solvers import dc
from eigenexa_tpu_torch.solvers.solver import (_DC_LEAF, SolveInfo,
                                               dc_flop_model, flop_model,
                                               matrix_scaling, profiled)
from eigenexa_tpu_torch.solvers.trbak import back_transform
from eigenexa_tpu_torch.utils import profiler
from eigenexa_tpu_torch.utils.profiler import Profiler
from eigenexa_tpu_torch.utils.sync import device_sync

MODES = ("A", "N", "X", "T", "S", "C")


def _solve_h(a, nvec: int, mode: str, nb_f: int, nb_b: int,
             prof: Optional[Profiler]):
    """scale → complex TRD → real D&C (or eigvalsh of T) → complex TRBAK.
    ``a`` is consumed, as in the real drivers."""
    n = a.shape[0]
    dtype, dev = a.dtype, a.device

    stage = functools.partial(profiler.stage, prof, device=dev)

    # a complex multiply-add is four real ones; the D&C is real
    with stage("TRD-BLK", 4.0 * 4.0 / 3.0 * n ** 3):
        a_s, sigma = matrix_scaling(a)
        del a
        trd = tridiagonalize(a_s, nb=nb_f, donate=True)
        del a_s
    if mode == "N":
        # the JAX package's eigen_h takes the dense eigvalsh of T here
        with stage("EIGVALSH", 0.0):
            w = dc.eigvals_tridiag_dense(trd.d, trd.e) / sigma
        return w, None
    if mode == "C":
        return trd.d / sigma, torch.eye(n, nvec, dtype=dtype, device=dev)
    if mode == "S":
        w = trd.d / sigma
        z = torch.eye(n, nvec, dtype=dtype, device=dev)
    else:
        # A, X and T: the real D&C with real vectors; mode X does not
        # refine, as in the JAX package's eigen_h
        with stage("D&C", dc_flop_model(n)):
            w, s = dc.solve_tridiag(trd.d, trd.e, leaf=_DC_LEAF,
                                    vec_dtype=trd.d.dtype)
            w = w / sigma
        z = s[:, :nvec].to(dtype)   # convert_DtoZ: a new complex matrix
        del s
        if mode == "T":
            return w, z
    with stage("TRDBAK", 4.0 * 2.0 * nvec * n ** 2):
        z = back_transform(z, trd.v, trd.tau, nb=nb_b, donate=True)
    return w, z


def eigen_h(a, nvec: Optional[int] = None, mode: str = "A",
            ctx: Optional[EigenContext] = None, profile=False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], SolveInfo]:
    """Hermitian eigensolver: A = Z·diag(w)·Zᴴ with real ascending w.

    ``a`` is a Hermitian (n, n) tensor (a numpy array is moved to the
    context's device); it is not modified.  A real one is cast to c64, or
    to c128 from f64.  Modes as :func:`eigen_s`'s, with the JAX package's
    ``eigen_h`` differences: 'N' takes the eigenvalues of the dense T, 'X'
    is 'A' (no refinement), and there is no 'R'.  Returns (w ascending,
    float64 but in modes S and C, where it is T's real diagonal; Z (n×nvec)
    complex, or None in mode N; SolveInfo).  SolveInfo.flops is 4× the
    real model; profile=True fills SolveInfo.stages with the TRD-BLK /
    D&C (EIGVALSH in mode N) / TRDBAK split, and SolveInfo.spans and
    counters as :func:`eigen_s`'s (``profile`` may be a ``Profiler``).
    """
    if isinstance(a, tuple):
        raise NotImplementedError(
            "eigen_h: a (re, im) pair is the JAX package's real-pair path "
            "for a backend without complex dtypes, which the port leaves "
            "out (ROADMAP A13); pass a complex tensor")
    ctx = ctx or default_context()
    mode = mode.upper()
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; eigen_h takes {MODES}")
    apply_precision(ctx.config)
    cfg = ctx.config
    t0 = time.perf_counter()
    if not isinstance(a, torch.Tensor):
        a = as_tensor(a, device=ctx.device)
    if not a.is_complex():
        a = a.to(torch.complex128 if a.dtype == torch.float64
                 else torch.complex64)
    n = a.shape[0]
    nvec = n if nvec is None else min(nvec, n)
    prof = profiler.for_solve(profile)
    # hand the matrix over without a lingering frame binding
    holder = [a]
    del a
    with profiler.active(prof):
        w, z = _solve_h(holder.pop(), nvec, mode, cfg.panel_forward,
                        cfg.panel_backward, prof)
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    info = SolveInfo(flops=4.0 * flop_model(n, nvec, mode in ("A", "X", "S")),
                     elapsed=elapsed, n=n, nvec=nvec, mode=mode,
                     **profiled(prof))
    return w, z, info
