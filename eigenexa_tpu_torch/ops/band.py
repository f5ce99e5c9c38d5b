"""Blocked Householder band-2 (pentadiagonal) reduction: the PRD-BLK stage
of ``eigen_sx``.

Counterpart of ``eigenexa_tpu/ops/band.py`` (reference: src/eigen_prd.F:80
with MBAND=2 columns a step, eigen_prd.F:424; src/eigen_prd_t4x.F:83, the
two-column reflector generation; src/eigen_prd_t2.F:90, the PDSYMV2
two-vector matvec; src/eigen_prd_t6_3.F, compute_v with the 2×2 coupling
matrix).  Dense symmetric A → pentadiagonal P = Qᵀ·A·Q in ONE stage, two
columns a step, so the trailing update is a rank-2nb product as in the
tridiagonal path.

Two implementations of the panel loop, as ``ops/householder.py`` has:

* **rolled**: each panel factors ``nb`` columns of the live trailing block
  (a strided view) as nb/2 reflector pairs, reading it with a full matvec;
  the trailing update runs in place on ``A[k+nb:, k+nb:]`` through the
  ``sub_matmul`` kernel (``kernels.rank2k_update``); V goes to a second
  n×n matrix;
* **windowed**: rows keep their global indices in one n×n buffer, a window
  ``[t0·TM:, t0·TM:]`` shrinks group by group, the pair's matvec reads the
  window's lower triangle through ``kernels.symv_lower`` with nc = 2 (one
  workspace a window group), the trailing update is
  ``kernels.rank2k_update_window``, and each panel's reflectors go to its
  own dead columns.  The pair's in-panel corrections are subtracted in
  torch after the matvec (the fused ``panel=`` form takes one vector).

Either way a pair's reflectors and T are one ``kernels.pair_reflectors``
launch and its W columns with the stores one ``kernels.pair_update``
launch on the card (``csrc/householder.cu``), the plain versions on the
CPU.

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
from eigenexa_tpu_torch.ops.kernels import (WIN_TM, rank2k_update,
                                            rank2k_update_window, symv_lower,
                                            symv_workspace)
from eigenexa_tpu_torch.utils.profiler import span


class BandResult(NamedTuple):
    d: torch.Tensor    # (n,)   diagonal of the pentadiagonal P
    e1: torch.Tensor   # (n-1,) first sub-diagonal
    e2: torch.Tensor   # (n-2,) second sub-diagonal
    v: torch.Tensor    # (n, n) Householder vectors; column k zeroes
                       #        A[k+3:, k] (pivot row k+2)
    tau: torch.Tensor  # (n,)   reflector scales (0 -> identity)


def band2_panel(b: torch.Tensor, nb: int):
    """Factor ``nb`` (even) columns of the trailing matrix ``b`` (m×m) as
    nb/2 reflector pairs.  ``b`` is frozen at panel start; each pair sees
    the earlier ones through A_cur = B − U·Wᵀ − W·Uᵀ.  Returns (U, W, τ);
    after it the trailing update is b[nb:, nb:] −= U·Wᵀ + W·Uᵀ on rows nb:.
    A pair's spans: form, reflector, matvec, w (its four steps, named as
    the tridiagonal column's)."""
    m = b.shape[0]
    uw = b.new_zeros((m, 2 * nb))
    u_p, w_p = uw[:, :nb], uw[:, nb:]
    tau_p = b.new_zeros((nb,))
    for c0 in range(0, nb, 2):
        with span("prd.pair"):
            u, w = u_p[:, :c0], w_p[:, :c0]
            with span("prd.pair.form"):
                cols = b[:, c0:c0 + 2]
                if c0:
                    cols = cols - u @ w[c0:c0 + 2].T - w @ u[c0:c0 + 2].T
            with span("prd.pair.reflector"):
                v_pair, _, t = kernels.pair_reflectors(
                    cols, c0, tau_out=tau_p[c0:c0 + 2])
            # B·V, the PDSYMV2 analogue (reference: eigen_prd_au,
            # src/eigen_prd_t2.F:90), as two matvecs: on the H100 cuBLAS's
            # f32 product with two columns summed so much worse than its
            # matvec that the f32 reduction of Frank n=8192 kept w_scaled
            # 132 against 0.96 (tools/band_accuracy.py)
            with span("prd.pair.matvec"):
                b_v = torch.stack([b @ v_pair[:, 0], b @ v_pair[:, 1]],
                                  dim=1)
            with span("prd.pair.w"):
                kernels.pair_update(b_v, u_p, w_p, c0, v_pair, t)
    return u_p, w_p, tau_p


def _extract_band(b, u_p, w_p, r0: int, nb: int):
    """(d, e1, e2) of the panel columns r0 … r0+nb−1 from A_cur = B − U·Wᵀ
    − W·Uᵀ, rows kept in b's frame.  Exact at panel end: later reflectors
    act two rows below these entries."""
    rows = slice(r0, r0 + nb)

    def band(off):
        hi = slice(r0 + off, r0 + off + nb)
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
    d, e1, e2 = _extract_band(bp, u_p, w_p, 0, m)
    return u_p[:m, :m], tau_p[:m], d, e1[:m - 1], e2[:max(m - 2, 0)]


def _band2_rolled(work: torch.Tensor, nb: int) -> BandResult:
    """Rolled reduction; ``work`` is the working matrix and is destroyed."""
    n = work.shape[0]
    d = work.new_zeros((n,))
    e1 = work.new_zeros((n,))
    e2 = work.new_zeros((n,))
    v_full = work.new_zeros((n, n))
    tau_full = work.new_zeros((n,))
    k = 0
    while n - k > nb + 2:
        with span("prd.panel"):
            b = work[k:, k:]
            u_p, w_p, tau_p = band2_panel(b, nb)
            rows = slice(k, k + nb)
            d[rows], e1[rows], e2[rows] = _extract_band(b, u_p, w_p, 0, nb)
            # rank-2nb trailing update in place on the live block
            # (reference: eigen_common_2update, src/eigen_t1.F:68)
            with span("prd.update"):
                trail = b[nb:, nb:]
                rank2k_update(trail, u_p[nb:], w_p[nb:], out=trail)
            v_full[k:, rows] = u_p
            tau_full[rows] = tau_p
        k += nb
    if n > k:
        with span("prd.panel"):
            v, tau, dr, e1r, e2r = _band2_remainder(work[k:, k:])
            v_full[k:, k:] = v
            _put_tail(k, tau_full, d, e1, e2, tau, dr, e1r, e2r)
    return BandResult(d=d, e1=e1[:max(n - 1, 0)], e2=e2[:max(n - 2, 0)],
                      v=v_full, tau=tau_full)


def _put_tail(k, tau_full, d, e1, e2, tau, dr, e1r, e2r) -> None:
    tau_full[k:] = tau
    d[k:] = dr
    e1[k:k + e1r.shape[0]] = e1r
    e2[k:k + e2r.shape[0]] = e2r


# ---------------------------------------------------------------------------
# windowed (no-roll) band-2 reduction
# ---------------------------------------------------------------------------

def _pair_win(b: torch.Tensor, j0: int, t0: int, nb: int, ws: dict):
    """The pair recurrence in the fixed-buffer windowed frame (see
    ``householder._panel_win``): the panel's columns are j0 … j0+nb−1, the
    window ``[t0·TM:, t0·TM:]``, and the pair's matvec reads only the
    window's lower triangle (``kernels.symv_lower`` with nc = 2, the
    PDSYMV2 analogue, into the workspace ``ws``).  W is zeroed on rows
    < j0, which keeps the stale rows above the panel out of every live
    value."""
    n = b.shape[0]
    uw = b.new_zeros((n, 2 * nb))
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
                b_v = symv_lower(b, v_pair, t0=t0, **ws)
            with span("prd.pair.w"):
                kernels.pair_update(b_v, u_p, w_p, jc, v_pair, t,
                                    zero_rows=j0)
    return u_p, w_p, tau_p


def _band2_windowed(b: torch.Tensor, nb: int) -> BandResult:
    """No-roll PRD on ONE (n, n) working buffer ``b``, which is consumed and
    comes back as the result's v (the band-2 twin of
    ``householder._tridiagonalize_windowed``; the reference keeps V inside
    the factored matrix too, src/eigen_prd_t7.F).  The loop runs while more
    than nb+2 rows are live (JAX ``band.py:357``); the window group is the
    tridiagonal path's (``householder._win_group_size``)."""
    n = b.shape[0]
    d = b.new_zeros((n,))
    e1 = b.new_zeros((n,))
    e2 = b.new_zeros((n,))
    tau_full = b.new_zeros((n,))
    group = hh._win_group_size(n, nb)
    groups: dict = {}
    k = 0
    while n - k > nb + 2:
        groups.setdefault(k // group, []).append(k)
        k += nb
    for g in sorted(groups):
        t0 = (g * group) // WIN_TM
        # the pair matvec's output and scratch, one a window group
        ws = symv_workspace(b, t0, nc=2)
        for j0 in groups[g]:
            with span("prd.panel"):
                u_p, w_p, tau_p = _pair_win(b, j0, t0, nb, ws)
                rows = slice(j0, j0 + nb)
                d[rows], e1[rows], e2[rows] = _extract_band(b, u_p, w_p, j0,
                                                            nb)
                with span("prd.update"):
                    rank2k_update_window(b, u_p, w_p, t0=t0)
                # store V in place of the just-processed (dead) panel
                # columns
                b[:, rows] = u_p
                tau_full[rows] = tau_p
    if n > k:
        # the live corner, which the full-square window update keeps
        # current in both triangles
        with span("prd.panel"):
            v, tau, dr, e1r, e2r = _band2_remainder(b[k:, k:].clone())
            b[:k, k:] = 0
            b[k:, k:] = v
            _put_tail(k, tau_full, d, e1, e2, tau, dr, e1r, e2r)
    return BandResult(d=d, e1=e1[:max(n - 1, 0)], e2=e2[:max(n - 2, 0)],
                      v=b, tau=tau_full)


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
    if impl == "windowed":
        return _band2_windowed(work, nb)
    return _band2_rolled(work, nb)


def assemble_band2(d, e1, e2) -> torch.Tensor:
    """Dense pentadiagonal matrix from its three bands."""
    t = torch.diag(d)
    if d.shape[0] > 1:
        t = t + torch.diag(e1, 1) + torch.diag(e1, -1)
    if d.shape[0] > 2:
        t = t + torch.diag(e2, 2) + torch.diag(e2, -2)
    return t
