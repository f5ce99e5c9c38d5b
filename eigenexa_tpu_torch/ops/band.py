"""Blocked Householder band-2 (pentadiagonal) reduction: the PRD-BLK stage
of ``eigen_sx``.

Counterpart of ``eigenexa_tpu/ops/band.py`` (reference: src/eigen_prd.F:80
with MBAND=2 columns a step, eigen_prd.F:424; src/eigen_prd_t4x.F:83, the
two-column reflector generation; src/eigen_prd_t2.F:90, the PDSYMV2
two-vector matvec; src/eigen_prd_t6_3.F, compute_v with the 2×2 coupling
matrix).  Dense symmetric A → pentadiagonal P = Qᵀ·A·Q in ONE stage, two
columns a step, so the trailing update is a rank-2nb product as in the
tridiagonal path.

One panel loop (``_band2``) in the two frames of ``ops/householder.py``
(``_Rolled``, ``_Windowed``), and one pair body (``_pairs``) whose matvec
the panel's frame gives: two matvecs on the rolled view, or
``kernels.symv_lower`` with nc = 2 on the window's lower triangle (one
workspace a window group).  Either way a pair's reflectors and T are one
``kernels.pair_reflectors`` launch, and its W columns, with the in-panel
corrections and the stores, one ``kernels.pair_update`` call on the card
(``csrc/householder.cu``), the plain versions on the CPU.

Reflector storage matches ``TridiagResult``: column k of ``v`` holds the
reflector that zeroes A[k+3:, k] (pivot row k+2, zeros in rows ≤ k+1), so
the WY back-transform (``solvers/trbak.py``) applies unchanged (reference:
eigen_common_trbakwy handles MBAND 1 or 2, src/trbakwy4.F:77).

The JAX package's scan bucketing, per-group jit and donation plumbing are
TPU compile workarounds and are not ported: the panels run eagerly on
shrinking views.  Real symmetric input only: the Hermitian driver,
``eigen_h``, takes the tridiagonal reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenexa_tpu_torch.ops import householder as hh
from eigenexa_tpu_torch.ops import kernels
from eigenexa_tpu_torch.ops.kernels import (WIN_TM, symv_lower,
                                            symv_workspace)
from eigenexa_tpu_torch.utils.profiler import span


class BandResult(NamedTuple):
    d: torch.Tensor    # (n,)   diagonal of the pentadiagonal P
    e1: torch.Tensor   # (n-1,) first sub-diagonal
    e2: torch.Tensor   # (n-2,) second sub-diagonal
    v: torch.Tensor    # (n, n) Householder vectors; column k zeroes
                       #        A[k+3:, k] (pivot row k+2)
    tau: torch.Tensor  # (n,)   reflector scales (0 -> identity)


def _pairs(b, j0: int, nb: int, matvec):
    """The pair recurrence over a panel's columns j0 … j0+nb−1 of ``b``
    (frozen at panel start): each pair sees the earlier ones through
    A_cur = B − U·Wᵀ − W·Uᵀ, and W is zeroed on rows < j0, which keeps the
    windowed frame's stale rows above the panel out of every live value.
    The frame gives ``j0`` and the matvec ``matvec(v_pair)``.  U and W are
    the two halves of one (m, 2nb) buffer.  Returns (U, W, τ).  A pair's
    spans: form, reflector, matvec, w (its four steps, named as the
    tridiagonal column's)."""
    uw = b.new_zeros((b.shape[0], 2 * nb))
    u_p, w_p = uw[:, :nb], uw[:, nb:]
    tau_p = b.new_zeros((nb,))
    for jc in range(0, nb, 2):
        c0 = j0 + jc
        with span("prd.pair"):
            u, w = u_p[:, :jc], w_p[:, :jc]
            with span("prd.pair.form"):
                cols = b[:, c0:c0 + 2]
                if jc:
                    cols = cols - u @ w[c0:c0 + 2].T - w @ u[c0:c0 + 2].T
            with span("prd.pair.reflector"):
                v_pair, _, t = kernels.pair_reflectors(
                    cols, c0, tau_out=tau_p[jc:jc + 2])
            with span("prd.pair.matvec"):
                b_v = matvec(v_pair)
            with span("prd.pair.w"):
                kernels.pair_update(b_v, u_p, w_p, jc, v_pair, t,
                                    zero_rows=j0)
    return u_p, w_p, tau_p


def _two_matvecs(b, v_pair):
    """B·V of a pair, the PDSYMV2 analogue (reference: eigen_prd_au,
    src/eigen_prd_t2.F:90), as two matvecs: on the H100 cuBLAS's f32
    product with two columns summed so much worse than its matvec that the
    f32 reduction of Frank n=8192 kept w_scaled 132 against 0.96
    (tools/band_accuracy.py)."""
    return torch.stack([b @ v_pair[:, 0], b @ v_pair[:, 1]], dim=1)


def band2_panel(b: torch.Tensor, nb: int):
    """Factor ``nb`` (even) columns of the trailing matrix ``b`` (m×m) as
    nb/2 reflector pairs: the rolled frame's panel.  Returns (U, W, τ);
    after it the trailing update is b[nb:, nb:] −= U·Wᵀ + W·Uᵀ on rows
    nb:."""
    return _pairs(b, 0, nb, lambda v_pair: _two_matvecs(b, v_pair))


def _extract_band(b, u_p, w_p, nb: int):
    """(d, e1, e2) of the first nb columns of A_cur = B − U·Wᵀ − W·Uᵀ.
    Exact at panel end: later reflectors act two rows below these
    entries."""
    rows = slice(0, nb)

    def band(off):
        hi = slice(off, off + nb)
        corr = (u_p[hi] * w_p[rows] + w_p[hi] * u_p[rows]).sum(dim=1)
        return b.diagonal(-off)[rows] - corr

    return band(0), band(1), band(2)


def _band2_remainder(corner: torch.Tensor):
    """The last block (m ≤ nb+2): padded by two zero rows and columns (to
    an even size) so that the extraction of its last columns stays in
    bounds, then factored whole.  Returns (V (m, m), τ (m,), d, e1, e2)."""
    m = corner.shape[0]
    mp = hh._round_up(m + 2, 2)
    bp = corner.new_zeros((mp, mp))
    bp[:m, :m] = corner
    u_p, w_p, tau_p = band2_panel(bp, mp)
    d, e1, e2 = _extract_band(bp, u_p, w_p, m)
    return u_p[:m, :m], tau_p[:m], d, e1[:m - 1], e2[:max(m - 2, 0)]


def _band2(work: torch.Tensor, nb: int, frame_type) -> BandResult:
    """The panel loop in the rolled or the windowed frame
    (``householder._Rolled``, ``_Windowed``); ``work`` is the working matrix
    and is destroyed (the windowed frame returns it as v, as the reference
    keeps V inside the factored matrix, src/eigen_prd_t7.F).  It runs while
    more than nb+2 rows are live (JAX ``band.py:357``)."""
    n = work.shape[0]
    d = work.new_zeros((n,))
    e1 = work.new_zeros((n,))
    e2 = work.new_zeros((n,))
    frame = frame_type(work, nb)
    tau_full = work.new_zeros((n,))
    groups, k = hh._win_schedule(n, nb, frame.group, spare=2)
    for g in sorted(groups):
        t0 = (g * frame.group) // WIN_TM
        if frame.windowed:
            # the pair matvec's output and scratch, one a window group
            ws = symv_workspace(work, t0, nc=2)
        for j0 in groups[g]:
            with span("prd.panel"):
                if frame.windowed:
                    # the pair's matvec reads only the window's lower
                    # triangle (the PDSYMV2 analogue with nc = 2)
                    u_p, w_p, tau_p = _pairs(
                        work, j0, nb,
                        lambda v_pair: symv_lower(work, v_pair, t0=t0, **ws))
                else:
                    u_p, w_p, tau_p = band2_panel(work[j0:, j0:], nb)
                top = frame.top(j0)
                rows = slice(j0, j0 + nb)
                d[rows], e1[rows], e2[rows] = _extract_band(
                    work[j0:, j0:], u_p[top:], w_p[top:], nb)
                with span("prd.update"):
                    frame.update(j0, u_p, w_p, t0)
                frame.store(j0, u_p)
                tau_full[rows] = tau_p
    if n > k:
        with span("prd.panel"):
            v, tau, dr, e1r, e2r = _band2_remainder(work[k:, k:])
            frame.store(k, v)
            tau_full[k:] = tau
            d[k:] = dr
            e1[k:k + e1r.shape[0]] = e1r
            e2[k:k + e2r.shape[0]] = e2r
    return BandResult(d=d, e1=e1[:max(n - 1, 0)], e2=e2[:max(n - 2, 0)],
                      v=frame.v, tau=tau_full)


def band2_reduce(a: torch.Tensor, nb: int = 64, impl: str = "auto",
                 donate: bool = False) -> BandResult:
    """Reduce symmetric A (n×n) to pentadiagonal P = Qᵀ·A·Q (reference:
    src/eigen_prd.F:80).  ``nb`` is forced even.  ``impl`` is "rolled",
    "windowed" or "auto", which follows ``householder.TRD_IMPL`` and, if
    that is "auto" too, the memory rule with eigen_sx's constants
    (``householder._auto_impl``).  With ``donate=True`` ``a`` is the
    working matrix and is destroyed; the windowed path returns it as v."""
    if a.is_complex():
        raise NotImplementedError("band2_reduce: real symmetric input "
                                  "only; eigen_h solves Hermitian input")
    nb += nb % 2
    if impl == "auto":
        impl = hh.TRD_IMPL
    if impl == "auto":
        impl = hh._auto_impl(a, band=2)
    if impl not in ("rolled", "windowed"):
        raise ValueError(f"band2_reduce: unknown impl {impl!r}")
    work = a if donate else a.clone(memory_format=torch.contiguous_format)
    return _band2(work, nb,
                  hh._Windowed if impl == "windowed" else hh._Rolled)


def assemble_band2(d, e1, e2) -> torch.Tensor:
    """Dense pentadiagonal matrix from its three bands."""
    t = torch.diag(d)
    if d.shape[0] > 1:
        t = t + torch.diag(e1, 1) + torch.diag(e1, -1)
    if d.shape[0] > 2:
        t = t + torch.diag(e2, 2) + torch.diag(e2, -2)
    return t
