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
from eigenexa_tpu_torch.ops.householder import householder_vector
from eigenexa_tpu_torch.ops.kernels import (WIN_TM, rank2k_update,
                                            rank2k_update_window, symv_lower,
                                            symv_workspace)


class BandResult(NamedTuple):
    d: torch.Tensor    # (n,)   diagonal of the pentadiagonal P
    e1: torch.Tensor   # (n-1,) first sub-diagonal
    e2: torch.Tensor   # (n-2,) second sub-diagonal
    v: torch.Tensor    # (n, n) Householder vectors; column k zeroes
                       #        A[k+3:, k] (pivot row k+2)
    tau: torch.Tensor  # (n,)   reflector scales (0 -> identity)


def pair_reflectors(x0, x1, c0: int):
    """The band-2 reflector pair for columns (c0, c0+1), the tall-skinny-QR
    scheme of eigen_prd_compute_u (src/eigen_prd_t4x.F:83):

    1. CholeskyQR2: the second column is orthogonalized against the first
       through its Gram coefficient, exactly twice (eigen_prd_t4x.F:140-283);
    2. reflector 0 from the first column, pivot row c0+2;
    3. H₀ applied to the orthogonalized second column analytically,
       v₀ᵀ·a₁ = −β₀·a₁[p₀]/(α₀−β₀), divided only where τ₀ ≠ 0 (the
       reference's rank-1 fix-up, eigen_prd_t4x.F:305);
    4. reflector 1 from the result, pivot row c0+3.

    The JAX function takes the masks ``idx > c0+1`` and ``idx > c0+2``; the
    port's ``householder_vector`` takes the pivots c0+2 and c0+3.  Returns
    (V (m, 2), τ₀, τ₁, T (2, 2)) with H₀·H₁ = I − V·T·Vᵀ, T upper
    triangular.
    """
    m = x0.shape[0]
    p = c0 + 2
    a0 = x0.clone()
    a0[:p] = 0
    a1 = x1.clone()
    a1[:p] = 0
    t11 = torch.dot(a0, a0)
    pos = t11 > 0
    safe_t11 = torch.where(pos, t11, torch.ones_like(t11))
    zero = torch.zeros_like(t11)
    for _ in range(2):           # CholeskyQR2: twice is enough
        s12 = torch.dot(a0, a1) / safe_t11
        a1 = a1 - torch.where(pos, s12, zero) * a0
    v0, tau0, beta0 = householder_vector(a0, p)
    p0 = min(p, m - 1)
    denom0 = torch.where(tau0 != 0, a0[p0] - beta0, torch.ones_like(tau0))
    vta1 = -beta0 * a1[p0] / denom0
    c1 = a1 - tau0 * vta1 * v0
    v1, tau1, _ = householder_vector(c1, p + 1)
    t01 = -tau0 * tau1 * torch.dot(v0, v1)
    t = torch.stack([torch.stack([tau0, t01]), torch.stack([zero, tau1])])
    return torch.stack([v0, v1], dim=1), tau0, tau1, t


def _pair_update(b_v, u, w, v_pair, t):
    """W's two columns for the pair: P = (B·V − U·(WᵀV) − W·(UᵀV))·T and
    W = P − ½·V·(Tᵀ·Vᵀ·P), so that Hᵀ·A·H = A − V·Wᵀ − W·Vᵀ (the 2×2
    coupling matrix of eigen_prd_compute_v, src/eigen_prd.F:363).  ``b_v``
    is B·V; ``u``, ``w`` the panel's earlier columns."""
    if u.shape[1]:
        b_v = b_v - u @ (w.T @ v_pair) - w @ (u.T @ v_pair)
    p = b_v @ t
    s = t.T @ (v_pair.T @ p)
    return p - 0.5 * (v_pair @ s)


def band2_panel(b: torch.Tensor, nb: int):
    """Factor ``nb`` (even) columns of the trailing matrix ``b`` (m×m) as
    nb/2 reflector pairs.  ``b`` is frozen at panel start; each pair sees
    the earlier ones through A_cur = B − U·Wᵀ − W·Uᵀ.  Returns (U, W, τ);
    after it the trailing update is b[nb:, nb:] −= U·Wᵀ + W·Uᵀ on rows nb:."""
    m = b.shape[0]
    uw = b.new_zeros((m, 2 * nb))
    u_p, w_p = uw[:, :nb], uw[:, nb:]
    tau_p = b.new_zeros((nb,))
    for c0 in range(0, nb, 2):
        u, w = u_p[:, :c0], w_p[:, :c0]
        cols = b[:, c0:c0 + 2]
        if c0:
            cols = cols - u @ w[c0:c0 + 2].T - w @ u[c0:c0 + 2].T
        v_pair, tau0, tau1, t = pair_reflectors(cols[:, 0], cols[:, 1], c0)
        # B·V, the PDSYMV2 analogue (reference: eigen_prd_au,
        # src/eigen_prd_t2.F:90), as two matvecs: on the H100 cuBLAS's f32
        # product with two columns summed so much worse than its matvec that
        # the f32 reduction of Frank n=8192 kept w_scaled 132 against 0.96
        # (tools/band_accuracy.py)
        b_v = torch.stack([b @ v_pair[:, 0], b @ v_pair[:, 1]], dim=1)
        w_p[:, c0:c0 + 2] = _pair_update(b_v, u, w, v_pair, t)
        u_p[:, c0:c0 + 2] = v_pair
        tau_p[c0:c0 + 2] = torch.stack([tau0, tau1])
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
        b = work[k:, k:]
        u_p, w_p, tau_p = band2_panel(b, nb)
        rows = slice(k, k + nb)
        d[rows], e1[rows], e2[rows] = _extract_band(b, u_p, w_p, 0, nb)
        # rank-2nb trailing update in place on the live block
        # (reference: eigen_common_2update, src/eigen_t1.F:68)
        trail = b[nb:, nb:]
        rank2k_update(trail, u_p[nb:], w_p[nb:], out=trail)
        v_full[k:, rows] = u_p
        tau_full[rows] = tau_p
        k += nb
    if n > k:
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
        u, w = u_p[:, :jc], w_p[:, :jc]
        cols = b[:, c0:c0 + 2]
        if jc:
            cols = cols - u @ w[c0:c0 + 2].T - w @ u[c0:c0 + 2].T
        v_pair, tau0, tau1, t = pair_reflectors(cols[:, 0], cols[:, 1], c0)
        b_v = symv_lower(b, v_pair, t0=t0, **ws)
        w_pair = _pair_update(b_v, u, w, v_pair, t)
        w_pair[:j0] = 0
        u_p[:, jc:jc + 2] = v_pair
        w_p[:, jc:jc + 2] = w_pair
        tau_p[jc:jc + 2] = torch.stack([tau0, tau1])
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
            u_p, w_p, tau_p = _pair_win(b, j0, t0, nb, ws)
            rows = slice(j0, j0 + nb)
            d[rows], e1[rows], e2[rows] = _extract_band(b, u_p, w_p, j0, nb)
            rank2k_update_window(b, u_p, w_p, t0=t0)
            # store V in place of the just-processed (dead) panel columns
            b[:, rows] = u_p
            tau_full[rows] = tau_p
    if n > k:
        # the live corner, which the full-square window update keeps
        # current in both triangles
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
