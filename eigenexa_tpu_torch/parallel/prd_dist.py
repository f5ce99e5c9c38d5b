"""Distributed band-2 (pentadiagonal) reduction (counterpart of
``eigenexa_tpu/parallel/prd_dist.py``; reference: the panel loop of
src/eigen_prd.F:341 with MBAND = 2 columns a step, eigen_prd.F:424; the
two-column reflector generation src/eigen_prd_t4x.F:83; the two-vector
matvec PDSYMV2, src/eigen_prd_t2.F:90, after one two-vector datacast,
datacast_dbl2, src/comm.F:1569; the rank-2nb trailing update
src/eigen_t1.F:68).

The band-2 twin of ``trd_dist.trd_panel_shard``, one rank's part, on the
same layout: the N×N matrix block-sharded over ('x', 'y'), every panel a
full-matrix masked update, every collective through
``parallel/collectives.py``, V stored sharded like A so that
``trd_dist.trbak_shard`` applies unchanged (column k holds the reflector
with pivot row k+2, the ``ops/band.BandResult`` convention).  Both block
sizes must be even, so that a pair of columns never straddles a block: the
driver pads to lcm(2·px, 2·py, nb) (``distributed.padded_size``).  Real
symmetric input only, as ``ops/band.py``.

Per pair of columns the reduction makes eight collectives, where the JAX
package makes sixteen (prd_dist.py:66-138); sums that depend on nothing
computed between them share one:

* the two columns, broadcast along 'y';
* CholeskyQR2 of the pair in two sums along 'x': (t11, a0·a1), then (a0·a1,
  and the pivot entries of a0 and a1, which the analytic H₀ fix-up needs);
* the two reflectors' norms, one all_gather along 'x' each
  (``trd_dist._dist_householder``, pivots c0+2 and c0+3);
* the datacast of V's two columns, with the panel corrections Uᵀ·V and
  Wᵀ·V and v0·v1 summed along 'x' in the same all_gather
  (``collectives.datacast_block_and_sum``);
* B·V's local product, summed along 'y';
* the 2×2 coupling S = Tᵀ·Vᵀ·P, summed along 'x' with the next pair's
  rows of U, W and P from their owner (the JAX package broadcasts the U/W
  row pair along 'x' at the start of each pair; every rank completes the
  rows' last two entries of W, which need S, itself, and the owner keeps
  the same values).

The band is read off the final matrix with one sum over the grid: a
similarity with reflectors whose support starts two rows below an entry
already produced leaves it as it is (prd_dist.py:24-27).
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops.kernels import sub_matmul
from eigenexa_tpu_torch.parallel.collectives import (CommStats,
                                                     bcast_from_owner,
                                                     datacast_block,
                                                     datacast_block_and_sum,
                                                     psum_grid, psum_x,
                                                     psum_y)
from eigenexa_tpu_torch.parallel.trd_dist import _dist_householder


def _pair_reflectors(cols, g_x, row0: int, c0: int, mesh):
    """The reflector pair of columns (c0, c0+1), the distributed twin of
    ``kernels.pair_reflectors`` (reference: eigen_prd_compute_u,
    src/eigen_prd_t4x.F:83).  cols: this rank's rows [row0, row0 + m_x) of
    the two columns; g_x: their global indices.  Returns (V (m_x, 2), τ₀,
    τ₁), the same τ on every rank; T's corner needs v0·v1, which the
    caller sums with the panel corrections."""
    m_x = cols.shape[0]
    keep = g_x > c0 + 1
    a0 = torch.where(keep, cols[:, 0], 0)
    a1 = torch.where(keep, cols[:, 1], 0)
    t11, s = psum_x(torch.stack([torch.dot(a0, a0), torch.dot(a0, a1)]),
                    mesh)
    pos = t11 > 0
    safe_t11 = torch.where(pos, t11, torch.ones_like(t11))
    zero = torch.zeros_like(t11)
    a1 = a1 - torch.where(pos, s / safe_t11, zero) * a0
    # CholeskyQR2's second round, with the pivot entries of a0 and of this
    # round's a1 (one rank owns row c0+2; the others add exact zeros)
    p_l = c0 + 2 - row0
    piv = (torch.stack([a0[p_l], a1[p_l]]) if 0 <= p_l < m_x
           else torch.zeros(2, dtype=a0.dtype, device=a0.device))
    s, alpha0, piv1 = psum_x(torch.cat([torch.dot(a0, a1)[None], piv]), mesh)
    s12 = torch.where(pos, s / safe_t11, zero)
    a1 = a1 - s12 * a0
    piv1 = piv1 - s12 * alpha0        # a1[c0+2] after the round
    v0, tau0, beta0 = _dist_householder(a0, mesh, c0 + 2, row0)
    # H₀ on a1 analytically: v0ᵀ·a1 = −β₀·a1[p₀]/(α₀ − β₀) by the pair's
    # orthogonality (eigen_prd_t4x.F:305), divided only where τ₀ ≠ 0
    denom0 = torch.where(tau0 != 0, alpha0 - beta0, torch.ones_like(tau0))
    c1 = a1 - tau0 * (-beta0 * piv1 / denom0) * v0
    v1, tau1, _ = _dist_householder(c1, mesh, c0 + 3, row0)
    return torch.stack([v0, v1], dim=1), tau0, tau1


def prd_panel_shard(a_loc, nb: int, mesh):
    """One rank's part of the band-2 reduction of the block-sharded N×N
    matrix (JAX ``prd_panel_shard``, prd_dist.py:45).

    a_loc: this rank's (m_x, m_y) block, m_x and m_y even, updated in
    place; nb even.  Returns (d, e1, e2, tau, all (N,) and the same on
    every rank, e1[k] = P[k+1, k] and e2[k] = P[k+2, k]; v_loc (m_x, m_y),
    this rank's block of V).  Panels of nb columns, nb/2 pairs each; each
    panel ends in one ``sub_matmul`` trailing update of the whole block."""
    m_x, m_y = a_loc.shape
    n_tot = m_x * mesh.px
    dtype, dev = a_loc.dtype, a_loc.device
    row0, col0 = mesh.ix * m_x, mesh.iy * m_y
    g_x = row0 + torch.arange(m_x, device=dev)
    v_loc = torch.zeros_like(a_loc)
    tau_all = torch.zeros(n_tot, dtype=dtype, device=dev)
    zero_cols = torch.zeros((m_x, 2), dtype=dtype, device=dev)
    zero_rows = torch.zeros(2 * (2 * nb + 2), dtype=dtype, device=dev)
    u_p = torch.zeros((m_x, nb), dtype=dtype, device=dev)
    w_p = torch.zeros_like(u_p)
    for ps in range(0, n_tot, nb):
        u_p.zero_()
        w_p.zero_()
        live = (g_x >= ps)[:, None]      # the trailing matrix's rows
        uw = zero_rows[:4 * nb].reshape(2, 2 * nb)   # rows c0, c0+1 of U, W
        for j in range(0, nb, 2):
            c0 = ps + j
            # columns c0, c0+1 of the panel-start matrix from their 'y'
            # owner (the bcastw_dbl two-vector broadcast, src/comm.F:1065)
            own_y = col0 <= c0 < col0 + m_y
            cols = bcast_from_owner(
                a_loc[:, c0 - col0:c0 - col0 + 2] if own_y else zero_cols,
                own_y, mesh, "y")
            cols = cols - u_p @ uw[:, nb:].T - w_p @ uw[:, :nb].T
            v_pair, tau0, tau1 = _pair_reflectors(cols, g_x, row0, c0, mesh)
            # one two-vector datacast (datacast_dbl2) with Uᵀ·V, Wᵀ·V and
            # v0·v1 summed along 'x'
            v_y, corr = datacast_block_and_sum(
                v_pair, torch.cat([(u_p.T @ v_pair).reshape(-1),
                                   (w_p.T @ v_pair).reshape(-1),
                                   torch.dot(v_pair[:, 0],
                                             v_pair[:, 1])[None]]),
                mesh, "x", "y", m_y)
            # B·V (PDSYMV2) as two matvecs: on the H100 cuBLAS's f32
            # product with two columns summed so much worse than its
            # matvec that the f32 reduction of Frank n=8192 kept w_scaled
            # 132 against 0.96 (ops/band.py:128-133)
            b_v = psum_y(torch.stack([a_loc @ v_y[:, 0], a_loc @ v_y[:, 1]],
                                     dim=1), mesh)
            b_v = torch.where(live, b_v, 0)
            utv = corr[:2 * nb].reshape(nb, 2)
            wtv = corr[2 * nb:4 * nb].reshape(nb, 2)
            zero = torch.zeros_like(tau0)
            t = torch.stack([torch.stack([tau0, -tau0 * tau1 * corr[-1]]),
                             torch.stack([zero, tau1])])
            # P = (B·V − U·(WᵀV) − W·(UᵀV))·T; W = P − ½·V·S with the 2×2
            # coupling S = Tᵀ·Vᵀ·P (src/eigen_prd.F:363)
            p = (b_v - u_p @ wtv - w_p @ utv) @ t
            u_p[:, j:j + 2] = v_pair
            # Vᵀ·P summed along 'x', with the next pair's rows of U, W and
            # P from their owner
            r = c0 + 2 - row0
            nxt = j + 2 < nb
            own_x = nxt and 0 <= r < m_x
            sums = psum_x(torch.cat(
                [(v_pair.T @ p).reshape(-1)]
                + ([torch.cat([u_p[r:r + 2], w_p[r:r + 2], p[r:r + 2]],
                              dim=1).reshape(-1) if own_x else zero_rows]
                   if nxt else [])), mesh)
            s = t.T @ sums[:4].reshape(2, 2)
            w_p[:, j:j + 2] = torch.where(live, p - 0.5 * (v_pair @ s), 0)
            if nxt:
                rows = sums[4:].reshape(2, 2 * nb + 2)
                uw = rows[:, :2 * nb].clone()
                uw[:, nb + j:nb + j + 2] = (rows[:, 2 * nb:]
                                            - 0.5 * (rows[:, j:j + 2] @ s))
                if own_x:
                    w_p[r:r + 2, j:j + 2] = uw[:, nb + j:nb + j + 2]
            tau_all[c0] = tau0
            tau_all[c0 + 1] = tau1
        # A −= U·W_yᵀ + W·U_yᵀ, the column copies one datacast each
        u_y = datacast_block(u_p, mesh, "x", "y", m_y)
        w_y = datacast_block(w_p, mesh, "x", "y", m_y)
        sub_matmul(a_loc, torch.cat([u_p, w_p], dim=1),
                   torch.cat([w_y, u_y], dim=1), out=a_loc)
        c0, c1 = max(ps, col0), min(ps + nb, col0 + m_y)
        if c0 < c1:
            v_loc[:, c0 - col0:c1 - col0] = u_p[:, c0 - ps:c1 - ps]
    # the band of the final matrix, each entry on one rank (eigen_prd's
    # final assembly, src/eigen_prd_t8.F): P[k+off, k] for off = 0, 1, 2
    bands = torch.zeros((3, n_tot), dtype=dtype, device=dev)
    for off in range(3):
        k0 = max(row0 - off, col0)
        k1 = min(row0 + m_x - off, col0 + m_y)
        if k0 < k1:
            k = torch.arange(k0, k1, device=dev)
            bands[off, k0:k1] = a_loc[k + off - row0, k - col0]
    d, e1, e2 = psum_grid(bands, mesh)
    return d, e1, e2, tau_all, v_loc


def comm_model_prd(n_pad: int, nb: int, px: int, py: int,
                   itemsize: int) -> CommStats:
    """CommStats of one ``prd_panel_shard`` run: every collective it makes
    times its trip count (the COMM_STAT accounting of
    src/eigen_devel.F:98-117), counted as ``trd_dist.comm_model_trd``
    counts: an all_gather that makes a sum records its values a rank."""
    st = CommStats()
    m_x = n_pad // px
    pairs = n_pad // 2
    panels = n_pad // nb
    # per pair: the two columns (y)
    st.record("bcast", pairs * 2 * m_x * itemsize, pairs)
    # per pair: CholeskyQR2's two rounds (2 and 3 values), the two norms
    # (3 each), B·V (2·m_x, along y) and S (4), which carries the next
    # pair's rows of U, W and P in all but a panel's last pair
    st.record("reduce", (pairs * (2 + 3 + 3 + 3 + 2 * m_x + 4)
                         + panels * (nb // 2 - 1) * 2 * (2 * nb + 2))
              * itemsize, 6 * pairs)
    # per pair: V's datacast with the corrections and v0·v1 (4·nb + 1 a
    # rank); per panel: U's and W's
    st.record("redist", pairs * (2 * n_pad + 4 * nb + 1) * itemsize, pairs)
    st.record("redist", panels * 2 * n_pad * nb * itemsize, 2 * panels)
    # the band's one sum over the grid
    st.record("reduce", 3 * n_pad * itemsize, 1)
    return st
