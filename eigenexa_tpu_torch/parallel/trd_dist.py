"""Distributed blocked Householder tridiagonalization and WY
back-transform (counterpart of ``eigenexa_tpu/parallel/trd_dist.py``;
reference: the panel loop of src/eigen_trd.F:349 with the per-column row and
column collectives of src/eigen_trd_t4.F:81 and src/eigen_trd_t2.F:161, the
``datacast`` transpose src/comm.F:1377, the rank-2nb trailing update
src/eigen_t1.F:68, and the WY back-transform src/trbakwy4_body.F:573-625,721
with its x-axis reductions :235,287).

Each function is the body of one rank: where the JAX package runs it under
``shard_map``, every rank of the mesh calls it on its own blocks, and the
``lax.psum``/``all_gather`` of an axis is a collective on the mesh's group
of that axis (``parallel/collectives.py``).

Layout, as in the JAX package: the N×N matrix (N = m_x·px = m_y·py) is
block-sharded, rank (ix, iy) holding rows [ix·m_x, (ix+1)·m_x) and columns
[iy·m_y, (iy+1)·m_y).  Every panel applies a full-matrix masked update (U
rows ≤ k and W rows before the panel are structurally zero), so every rank
does the same dense work a panel and no cyclic index algebra is needed
(trd_dist.py:16-27).  The trailing update and the WY update are one call
each of the hand-written ``sub_matmul`` kernel (B − P·Qᴴ, real and
complex).

Two departures from the JAX package (ROADMAP A17):

* V is stored sharded like A: rank (ix, iy) keeps the reflector columns of
  its own column block, and the back-transform broadcasts each block of
  reflectors along 'y' (the reference's bcast of the V panel).  The JAX
  package keeps V replicated along 'y' (``P("x", None)``);
* the back-transform runs over the caller's nvec columns only.

Per column the reduction makes five collectives, none over a group of one
rank, where the JAX package makes nine (trd_dist.py:97-150): the column's
broadcast along 'y'; the Householder norm's reduction along 'x' (one
all_gather where the JAX package makes three reductions,
``_dist_householder``); the datacast of v with the panel's couplings Uᴴv
and Wᴴv summed along 'x' in the same all_gather
(``collectives.datacast_block_and_sum``); a 'y' sum of the local matvec;
and the 'x' sum of vᴴq, which also carries the next column's row of U and
W from its owner (the JAX package broadcasts that row along 'x' at the
start of each column; every rank completes its last entry, which needs
vᴴq, itself, and the owner keeps the same value).
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops.householder import wy_t_from_gram
from eigenexa_tpu_torch.ops.kernels import sub_matmul
from eigenexa_tpu_torch.parallel.collectives import (CommStats, all_gather,
                                                     bcast_from_owner,
                                                     datacast_block,
                                                     datacast_block_and_sum,
                                                     psum_grid, psum_x,
                                                     psum_y)


def _dist_householder(col, mesh, pivot: int, row0: int):
    """Householder reflector of a column sharded along 'x' (the
    distributed twin of ``householder.householder_vector``; reference:
    eigen_trd_compute_u, src/eigen_trd_t4.F:81).

    col: this rank's rows [row0, row0 + m_x) of the column; the pivot is
    global row `pivot` and the tail the rows below it.  Returns (v local,
    tau, beta), tau and beta the same on every rank: zlarfg's convention,
    β real, the tail's norm pre-scaled against overflow.

    One collective: each rank scales its part of the tail by its own
    max-abs m_r and sends (its pivot entry, m_r, s_r = Σ|t/m_r|²) in one
    all_gather along 'x'; every rank then forms ‖tail‖ = scale·√(Σ_r
    s_r·(m_r/scale)²), scale = max_r m_r, in the same order (dnrm2's
    rescaling, split over the ranks).  The JAX package takes the max, the
    pivot and the sum of squares in three reductions (trd_dist.py:63-69);
    the two agree to roundoff."""
    m_x = col.shape[0]
    dtype = col.dtype
    rdtype = col.real.dtype
    tiny = torch.finfo(rdtype).tiny
    p_l = pivot - row0
    own_piv = 0 <= p_l < m_x
    t0 = min(max(p_l + 1, 0), m_x)
    tail = col[t0:]
    zero = torch.zeros((), dtype=rdtype, device=col.device)
    m_loc = tail.abs().amax() if t0 < m_x else zero
    s_loc = (tail / torch.clamp_min(m_loc, tiny)).abs().square().sum()
    alpha_loc = (col[p_l] if own_piv
                 else torch.zeros((), dtype=dtype, device=col.device))
    parts = all_gather(torch.stack([alpha_loc, m_loc.to(dtype),
                                    s_loc.to(dtype)]), mesh, "x")
    parts = parts.reshape(-1, 3)
    alpha = parts[:, 0].sum()
    m_r, s_r = parts[:, 1].real, parts[:, 2].real
    scale = torch.clamp_min(m_r.amax(), tiny)
    xnorm = torch.sqrt((s_r * (m_r / scale).square()).sum()) * scale
    alphr = alpha.real
    alphi = alpha.imag if col.is_complex() else torch.zeros_like(alphr)
    mag = torch.sqrt(alphr * alphr + alphi * alphi + xnorm * xnorm)
    beta = torch.where(alphr >= 0, -mag, mag)
    active = (xnorm > 0) | (alphi != 0)
    one = torch.ones_like(beta)
    safe_beta = torch.where(active, beta, one)
    tau = torch.where(active, (safe_beta - alpha) / safe_beta,
                      torch.zeros_like(alpha))
    denom = torch.where(active, alpha - safe_beta, one.to(dtype))
    v = torch.zeros_like(col)
    v[t0:] = tail / denom
    if own_piv:
        v[p_l] = active.to(dtype)
    return v, tau, torch.where(active, beta, alphr)


def trd_panel_shard(a_loc, nb: int, mesh):
    """One rank's part of the reduction of the block-sharded N×N matrix to
    a real tridiagonal T (JAX ``trd_panel_shard``, trd_dist.py:86).

    a_loc: this rank's (m_x, m_y) block, updated in place (the caller hands
    it over).  Returns (d (N,), e (N,), tau (N,), all the same on every
    rank, and v_loc (m_x, m_y): the reflectors' entries in this rank's
    block of V).  The panels run over all N columns, nb at a time; each
    column follows the reference's pattern (column broadcast along 'y',
    U/W row broadcast along 'x', the norm's reductions along 'x', datacast
    of v, the matvec summed along 'y', the panel's couplings summed along
    'x'), and each panel ends in one rank-2nb trailing update on the whole
    block (eigen_common_2update, src/eigen_t1.F:68)."""
    m_x, m_y = a_loc.shape
    n_tot = m_x * mesh.px
    dtype, dev = a_loc.dtype, a_loc.device
    rdtype = a_loc.real.dtype
    row0, col0 = mesh.ix * m_x, mesh.iy * m_y
    v_loc = torch.zeros_like(a_loc)
    tau_all = torch.zeros(n_tot, dtype=dtype, device=dev)
    e_all = torch.zeros(n_tot, dtype=rdtype, device=dev)
    zero_col = torch.zeros(m_x, dtype=dtype, device=dev)
    zero_row = torch.zeros(2 * nb + 2, dtype=dtype, device=dev)
    u_p = torch.zeros((m_x, nb), dtype=dtype, device=dev)
    w_p = torch.zeros_like(u_p)
    for ps in range(0, n_tot, nb):
        u_p.zero_()
        w_p.zero_()
        uw_row = zero_row[:2 * nb]   # rows k of U and W: zero at ps
        for j in range(nb):
            k = ps + j
            # column k of the panel-start matrix, from its 'y' owner
            own_y = col0 <= k < col0 + m_y
            col = bcast_from_owner(a_loc[:, k - col0] if own_y else zero_col,
                                   own_y, mesh, "y")
            # the in-panel rank-2 corrections (src/eigen_trd_t5.F:71)
            col = (col - u_p @ uw_row[nb:].conj()
                   - w_p @ uw_row[:nb].conj())
            v, tau, beta = _dist_householder(col, mesh, k + 1, row0)
            # v's column copy, and Uᴴv, Wᴴv summed along 'x'
            v_y, cuv = datacast_block_and_sum(
                v, torch.cat([u_p.conj().T @ v, w_p.conj().T @ v]), mesh,
                "x", "y", m_y)
            # q = A·v: local product, summed along 'y'
            q = psum_y(a_loc @ v_y, mesh)
            if ps > row0:
                q[:min(ps - row0, m_x)] = 0
            # q −= U·(Wᴴv) + W·(Uᴴv) (src/eigen_trd_t6_3.F:85)
            q = q - u_p @ cuv[nb:] - w_p @ cuv[:nb]
            u_p[:, j] = v
            # vᴴq summed along 'x', with the next column's rows of U and W
            # and its entries of v and q from their owner
            r = k + 1 - row0
            nxt = j + 1 < nb
            own_x = nxt and 0 <= r < m_x
            sums = psum_x(torch.cat(
                [(v.conj() * q).sum()[None]]
                + ([torch.cat([u_p[r], w_p[r], v[r:r + 1], q[r:r + 1]])
                    if own_x else zero_row] if nxt else [])), mesh)
            vq, c = sums[0], tau * tau.conj() * 0.5
            w_p[:, j] = tau * q - c * vq * v
            if nxt:
                uw_row = sums[1:2 * nb + 1].clone()
                uw_row[nb + j] = tau * sums[-1] - c * vq * sums[-2]
                if own_x:
                    w_p[r, j] = uw_row[nb + j]
            tau_all[k] = tau
            e_all[k] = beta
        # A −= U·W_yᴴ + W·U_yᴴ, the column copies one datacast each
        u_y = datacast_block(u_p, mesh, "x", "y", m_y)
        w_y = datacast_block(w_p, mesh, "x", "y", m_y)
        sub_matmul(a_loc, torch.cat([u_p, w_p], dim=1),
                   torch.cat([w_y, u_y], dim=1), out=a_loc)
        c0, c1 = max(ps, col0), min(ps + nb, col0 + m_y)
        if c0 < c1:
            v_loc[:, c0 - col0:c1 - col0] = u_p[:, c0 - ps:c1 - ps]
    # d: the diagonal of the updated matrix, each element on one rank
    # (eigen_trd_final, src/eigen_trd_t8.F:167)
    d_loc = torch.zeros(n_tot, dtype=rdtype, device=dev)
    g0, g1 = max(row0, col0), min(row0 + m_x, col0 + m_y)
    if g0 < g1:
        idx = torch.arange(g0, g1, device=dev)
        d_loc[g0:g1] = a_loc[idx - row0, idx - col0].real
    return psum_grid(d_loc, mesh), e_all, tau_all, v_loc


def comm_model_trd(n_pad: int, nb: int, px: int, py: int,
                   itemsize: int) -> CommStats:
    """CommStats of one ``trd_panel_shard`` run: every collective of the
    panel recurrence times its trip count (the JAX package's model,
    trd_dist.py:191, with the couplings Uᴴv and Wᴴv in v's datacast)."""
    st = CommStats()
    m_x = n_pad // px
    cols = n_pad
    panels = n_pad // nb
    # per column: col bcast (y), the norm's scalar reduces, v datacast with
    # the couplings (x), q reduce (y), vq reduce (x), which carries the
    # next row of U and W with its v and q entries in all but a panel's
    # last column
    st.record("bcast", cols * m_x * itemsize, cols)
    st.record("reduce", (cols * (3 + m_x + 1)
                         + panels * (nb - 1) * (2 * nb + 2)) * itemsize,
              3 * cols)
    st.record("redist", cols * (n_pad + 2 * nb) * itemsize, cols)
    # per panel: U/W panel datacasts
    st.record("redist", panels * 2 * n_pad * nb * itemsize, 2 * panels)
    # final diagonal assembly
    st.record("reduce", n_pad * itemsize, 1)
    return st


def _wy_blocks(n_tot: int, nb: int):
    """(start, width) of the back-transform's WY blocks, last first."""
    return [(k, min(nb, n_tot - 1 - k))
            for k in reversed(range(0, max(n_tot - 1, 0), nb))]


def comm_model_trbak(n_pad: int, nvec_loc: int, nb: int,
                     itemsize: int) -> CommStats:
    """CommStats of one ``trbak_shard`` run: the Gram and VᴴZ reductions
    of each block (src/trbakwy4_body.F:235,287; JAX trd_dist.py:216)."""
    st = CommStats()
    blocks = len(_wy_blocks(n_pad, nb))
    st.record("reduce", blocks * (nb * nb + nb * nvec_loc) * itemsize,
              2 * blocks)
    return st


def comm_model_v_bcast(n_pad: int, nb: int, px: int, py: int,
                       itemsize: int) -> CommStats:
    """CommStats of the back-transform's V broadcasts along 'y', one a WY
    block (the port's sharded V; none where py = 1)."""
    st = CommStats()
    if py > 1:
        blocks = _wy_blocks(n_pad, nb)
        st.record("bcast", sum(b for _, b in blocks) * (n_pad // px)
                  * itemsize, len(blocks))
    return st


def trbak_shard(z_loc, v_loc, tau, nb: int, mesh):
    """One rank's part of the WY back-transform Z ← Q·Z (JAX
    ``trbak_shard``, trd_dist.py:228).

    z_loc: this rank's rows [ix·m_x, (ix+1)·m_x) of Z, its block of
    columns, updated in place; v_loc: its block of V (``trd_panel_shard``);
    tau (N,).  Blocks of nb reflectors apply last first; per block the V
    panel is broadcast along 'y', the Gram matrix and VᴴZ are summed along
    'x', and Z −= V·(T·VᴴZ) is one ``sub_matmul`` call."""
    m_x, m_y = v_loc.shape
    col0 = mesh.iy * m_y
    for k, b in _wy_blocks(m_x * mesh.px, nb):
        if mesh.py == 1:
            vb = v_loc[:, k:k + b]
        else:
            vb = torch.zeros((m_x, b), dtype=v_loc.dtype,
                             device=v_loc.device)
            c0, c1 = max(k, col0), min(k + b, col0 + m_y)
            if c0 < c1:
                vb[:, c0 - k:c1 - k] = v_loc[:, c0 - col0:c1 - col0]
            vb = psum_y(vb, mesh)
        t = wy_t_from_gram(psum_x(vb.conj().T @ vb, mesh), tau[k:k + b])
        y = t @ psum_x(vb.conj().T @ z_loc, mesh)
        sub_matmul(z_loc, vb, y.mH.resolve_conj().contiguous(), out=z_loc)
    return z_loc
