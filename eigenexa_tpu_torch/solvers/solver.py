"""Public solver facade: ``eigen_s`` / ``eigen_sx`` / ``eigh``
(counterpart of ``eigenexa_tpu/solvers/solver.py``; reference:
src/eigen_s.F:30 and src/eigen_sx.F:30 — scale → reduce → solve the
reduced problem → back-transform → rescale).

``w, z, info = eigen_s(a, nvec=..., mode=...)``; ``info`` carries the
reference's in-band telemetry (src/eigen_s.F:284-295).  ``eigen_s``
reduces to tridiagonal form (TRD-BLK, ``ops/householder.tridiagonalize``)
and ``eigen_sx`` to pentadiagonal form in one stage (PRD-BLK,
``ops/band.band2_reduce``; banded D&C, ``solvers/dc_band.py``).  Modes
(benchmark/main2.f:243-258, src/eigen_sx.F:159-221):

  'A' — eigenvalues + eigenvectors (default)
  'N' — eigenvalues only, by Sturm bisection (BISECT); Z is None
  'X' — eigenvalues + eigenvectors, the D&C values refined by bisection
  'S' — skip the reduced solve: Z = Q·I (isolates the reduction + TRBAK)
  'T' — skip the back-transform: Z = eigenvectors of T (reduction + D&C)
  'C' — skip both: Z = I (isolates the reduction)
  'R' — no reduction: the D&C alone on saved stage data (``stage_data``: a
        directory of D.data/E.data[/F.data] or a (d, e[, e2]) tuple), ``a``
        may be None (src/eigen_sx.F:175-193)

Both reductions follow ``householder.TRD_IMPL``; where it is "auto", a
real matrix on the card takes the windowed reduction only if the rolled
solve would not fit the card's free memory (``householder._auto_impl``),
and every other input the rolled one.  The scaled temporary is donated to
the reduction; the
windowed one hands that same buffer back as the reflector matrix, so the
stage holds one n×n buffer beside the caller's input.  The bisection of
modes N and X runs on the card in ``csrc/sturm.cu``
(``kernels.sturm_bisect``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional, Tuple

import torch

from eigenexa_tpu_torch.interop import as_tensor
from eigenexa_tpu_torch.ops import sturm
from eigenexa_tpu_torch.ops.band import band2_reduce
from eigenexa_tpu_torch.ops.householder import tridiagonalize
from eigenexa_tpu_torch.runtime import (EigenContext, apply_precision,
                                        default_context)
from eigenexa_tpu_torch.solvers import dc
from eigenexa_tpu_torch.solvers.dc_band import solve_band2_dc
from eigenexa_tpu_torch.solvers.trbak import back_transform
from eigenexa_tpu_torch.utils import profiler
from eigenexa_tpu_torch.utils.profiler import Profiler
from eigenexa_tpu_torch.utils.stageio import load_stage_data
from eigenexa_tpu_torch.utils.sync import device_sync

MODES = ("A", "N", "X", "S", "T", "C", "R")
_PORTED_MODES = MODES
_DC_LEAF = 32   # D&C leaf size: 8 merge levels at n = 8192


@dataclasses.dataclass
class SolveInfo:
    """Telemetry contract (a(1,1)/a(2,1) analogue, src/eigen_s.F:284-295;
    the collective time a(3,1) comes with the distributed port, ROADMAP
    A17).  `stages` holds the TRD-BLK (PRD-BLK for eigen_sx) / D&C (BISECT
    in mode N) / TRDBAK seconds and flops when the solve ran with
    profile=True."""

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
        """Print the per-stage block (TRD-BLK or PRD-BLK / D&C or BISECT /
        TRDBAK / Total lines, reference: src/eigen_s.F:180-276)."""
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
    if mode not in _PORTED_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _reduce(a_s, nb_f: int, band: int):
    """The reduction of either driver on the donated scaled matrix:
    (result, off-diagonal bands)."""
    if band == 1:
        red = tridiagonalize(a_s, nb=nb_f, donate=True)
        return red, (red.e,)
    red = band2_reduce(a_s, nb=nb_f, donate=True)
    return red, (red.e1, red.e2)


def _solve_reduced(d, offd, vec_dtype):
    """The D&C of the reduced problem: tridiagonal (one off-diagonal band)
    or pentadiagonal (two).  Returns (w f64, S in vec_dtype)."""
    if len(offd) == 1:
        return dc.solve_tridiag(d, offd[0], leaf=_DC_LEAF,
                                vec_dtype=vec_dtype)
    return solve_band2_dc(d, *offd, leaf=_DC_LEAF, vec_dtype=vec_dtype)


def _solve(a, nvec: int, mode: str, nb_f: int, nb_b: int,
           prof: Optional[Profiler], band: int = 1):
    """scale → TRD (band 1) or PRD (band 2) → D&C or bisection → TRBAK.
    `a` is consumed: the caller hands it over without keeping a reference,
    so the unscaled matrix is freed before the reduction.  With `prof`,
    each stage is a timed region."""
    n = a.shape[0]
    in_dtype = a.dtype
    dev = a.device

    stage = functools.partial(profiler.stage, prof, device=dev)

    with stage("TRD-BLK" if band == 1 else "PRD-BLK", 4.0 / 3.0 * n ** 3):
        a_s, sigma = matrix_scaling(a)
        del a
        red, offd = _reduce(a_s, nb_f, band)
        del a_s
    if mode == "N":
        # eigenvalues only: Sturm bisection, no eigenvector work at all
        # (reference: eigen_bisect, src/bisect.F:67; eigen_bisect2,
        # src/bisect2.F:71)
        with stage("BISECT", 0.0):
            bisect = (sturm.eigvals_bisect if band == 1
                      else sturm.eigvals_bisect_band2)
            w = bisect(red.d, *offd) / sigma
        return w, None
    if mode == "C":
        return red.d / sigma, torch.eye(n, nvec, dtype=in_dtype, device=dev)
    if mode == "S":
        w = red.d / sigma
        z = torch.eye(n, nvec, dtype=in_dtype, device=dev)
    else:
        with stage("D&C", dc_flop_model(n)):
            w, s = _solve_reduced(red.d, offd, in_dtype)
            if mode == "X":
                # bisection refinement of the D&C values (reference:
                # bisect.F mode=1)
                refine = (sturm.refine_eigenvalues if band == 1
                          else sturm.refine_eigenvalues_band2)
                w = refine(red.d, *offd, w)
            w = w / sigma
        if mode == "T":
            return w, s[:, :nvec]
        z = s[:, :nvec].contiguous()
        del s
    with stage("TRDBAK", 2.0 * nvec * n ** 2):
        z = back_transform(z, red.v, red.tau, nb=nb_b, donate=True)
    return w, z


def _solve_stage_r(stage_data, nvec: Optional[int], band: int, vec_dtype,
                   device):
    """Mode 'R': read reduced-band data and run ONLY the D&C (reference:
    src/eigen_sx.F:175-193, D.data/E.data/F.data).  A directory is read
    onto ``device``; tensors of a tuple stay where they are, other arrays
    go to ``device``.  ``eigen_s`` (band 1) ignores an e2."""
    if isinstance(stage_data, (str, os.PathLike)):
        d, e1, e2 = load_stage_data(stage_data, device=device)
    else:
        d, e1 = stage_data[0], stage_data[1]
        e2 = stage_data[2] if len(stage_data) > 2 else None
    d, e1 = (x if isinstance(x, torch.Tensor) else as_tensor(x, device)
             for x in (d, e1))
    offd = (e1,)
    if band == 2 and e2 is not None:
        offd += (e2 if isinstance(e2, torch.Tensor)
                 else as_tensor(e2, device),)
    w, s = _solve_reduced(d, offd, vec_dtype)
    n = d.shape[0]
    return w, s[:, :n if nvec is None else min(nvec, n)]


def _drive(a, nvec: Optional[int], mode: str, ctx: Optional[EigenContext],
           stage_data, profile: bool, band: int):
    """What both drivers share: the context, the mode, the hand-over of the
    matrix, the clock and the telemetry."""
    ctx = ctx or default_context()
    mode = mode.upper()
    _check_mode(mode)
    apply_precision(ctx.config)
    cfg = ctx.config
    t0 = time.perf_counter()
    if mode == "R":
        vec_dtype = a.dtype if a is not None else torch.float64
        w, z = _solve_stage_r(stage_data, nvec, band, vec_dtype, ctx.device)
        device_sync(w, z)
        n = w.shape[0]
        return w, z, SolveInfo(flops=4.0 / 3.0 * n ** 3,
                               elapsed=time.perf_counter() - t0, n=n,
                               nvec=z.shape[1], mode=mode)
    if not isinstance(a, torch.Tensor):
        a = as_tensor(a, device=ctx.device)
    n = a.shape[0]
    nvec = n if nvec is None else min(nvec, n)
    prof = Profiler() if profile else None
    # hand the matrix over without a lingering frame binding
    holder = [a]
    del a
    w, z = _solve(holder.pop(), nvec, mode, cfg.panel_forward,
                  cfg.panel_backward, prof, band)
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    stages = {} if prof is None else prof.stages()
    info = SolveInfo(flops=flop_model(n, nvec, mode in ("A", "X", "S")),
                     elapsed=elapsed, n=n, nvec=nvec, mode=mode,
                     stages=stages)
    return w, z, info


def eigen_s(a, nvec: Optional[int] = None, mode: str = "A",
            ctx: Optional[EigenContext] = None, stage_data=None,
            profile: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], SolveInfo]:
    """Standard real-symmetric eigensolver (reference: src/eigen_s.F:30).

    ``a`` is a symmetric (n, n) tensor (a numpy array is moved to the
    context's device); it is not modified.  The solve runs on a's device.
    Returns (w ascending, Z (n×nvec) or None in mode N, SolveInfo).  w is
    float64 (the D&C and bisection dtype); Z has a's dtype.  Mode 'R' runs
    the D&C alone on ``stage_data`` (a directory written by
    ``utils.stageio.save_stage_data`` or a (d, e) tuple), on the context's
    device; ``a`` may be None, and Z is then float64.  profile=True fills
    SolveInfo.stages with the TRD-BLK / D&C (BISECT) / TRDBAK split
    (reference: src/eigen_s.F:180-276).
    """
    return _drive(a, nvec, mode, ctx, stage_data, profile, band=1)


def eigen_sx(a, nvec: Optional[int] = None, mode: str = "A",
             ctx: Optional[EigenContext] = None, stage_data=None,
             profile: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], SolveInfo]:
    """One-stage banded variant (reference: src/eigen_sx.F:30): dense →
    pentadiagonal by two-column Householder pairs (PRD-BLK) → banded D&C
    with two rank-1 merges a join → WY back-transform of the pair
    reflectors.  Same arguments, modes and returns as :func:`eigen_s`;
    mode 'R' runs the banded D&C on saved (d, e1, e2) data (a tuple
    without e2, or a directory without F.data, takes the tridiagonal
    D&C)."""
    return _drive(a, nvec, mode, ctx, stage_data, profile, band=2)


def eigh(a, nvec: Optional[int] = None, ctx: Optional[EigenContext] = None):
    """NumPy-style convenience wrapper: returns (w, Z)."""
    w, z, _ = eigen_s(a, nvec=nvec, mode="A", ctx=ctx)
    return w, z
