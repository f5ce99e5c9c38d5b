"""Distributed divide & conquer for the reduced pentadiagonal problem
(counterpart of ``eigenexa_tpu/solvers/dc_band_dist.py``; reference: the
banded D&C my_pdlaed0.F:18, two rank-1 merges a join, over the grid as the
FS merge tree, src/FS_PDLAED0.F90:62, src/FS_dividing.F90:22-55).

The band-2 twin of ``solvers/dc_dist.py``, one rank at a time:

* rows never move: flat rank r = ix·py + iy owns the n_pad/P tree rows
  [r·rloc, (r+1)·rloc);
* phase 1: the leaves and every join inside a rank's rows, with no
  communication (``dc_band._solve_blocks``: the port's leaves, two-merge
  levels and their panel-chunked form, in f64);
* phase 2: log2 P levels, each joining blocks of 2^t ranks.  The leader of
  each half puts in its block's eigenvalues, first two rows and last two
  rows, and three group sums (``collectives.grouped_allreduce``) replicate
  them over the group: every rank of it then solves the same two secular
  equations and multiplies its own rows into the merged basis.  A join at
  least `chunk_min` wide takes ``secular.rank1_merge_apply_parts``, so the
  top of the tree holds no (2s)² transform.

P must be a power of two, and so px and py (src/FS_libs.F90:183); other
meshes and P = 1 take the replicated ``dc_band.solve_band2_dc`` on every
rank.  The result goes out in the Z layout of ``dc_dist``.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenexa_tpu_torch.ops.secular import (rank1_merge_apply_parts,
                                            rank1_merge_core)
from eigenexa_tpu_torch.parallel.collectives import (CommStats,
                                                     grouped_allreduce)
from eigenexa_tpu_torch.solvers import dc_band
from eigenexa_tpu_torch.solvers.dc_dist import (LEAF, _block, _is_pow2,
                                                _tree_blocks, _tree_sizes)

F64 = torch.float64


def _dc_band_tree_shard(d_mod, e1_mod, e2_pad, coefs, mesh, leaf: int,
                        rloc: int, vec_dtype, chunk_min: int,
                        chunk_panel: int):
    """One rank's part of the band-2 merge tree (JAX
    ``_dc_band_tree_shard``, dc_band_dist.py:54).  The prepared tree
    (``dc_band._prepare``) is the same on every rank.  Returns (w (n_pad,),
    the same on every rank; q_loc (rloc, n_pad), this rank's rows of the
    eigenvectors)."""
    p, r = mesh.size, mesh.flat
    dev = d_mod.device
    w, q_loc, rows_lo, rows_hi = dc_band._solve_blocks(
        d_mod, e1_mod, e2_pad, coefs, r * rloc, rloc, leaf, vec_dtype,
        chunk_min, chunk_panel)
    one = torch.ones(1, dtype=F64, device=dev)
    for t in range(int(np.log2(p))):
        s = rloc << t                # child block width
        gsz = 1 << (t + 1)           # ranks of the merged block
        within = r % gsz
        half_off = 0 if within < gsz // 2 else s
        a, b, c, f, h = (x[((r // gsz) * 2 * s + s) // leaf - 1]
                         for x in coefs)
        lead = within in (0, gsz // 2)

        def gathered(x):
            """x of this half's block, placed in the merged block's
            coordinates and replicated over the group."""
            out = torch.zeros(x.shape[:-1] + (2 * s,), dtype=F64, device=dev)
            if lead:
                out[..., half_off:half_off + s] = x
            return grouped_allreduce(out, gsz, mesh)

        dm, lo, hi = gathered(w), gathered(rows_lo), gathered(rows_hi)
        # merge 1: u1 = a·δ_{p-2} + b·δ_{p-1} + c·δ_p, p = s: the left
        # block's last two rows, the right block's first
        z1 = torch.cat([a * hi[0, :s] + b * hi[1, :s], c * lo[0, s:]])
        lo_left, hi_right = lo[:, :s], hi[:, s:]
        pm1, pp1 = hi[1, None, :s], lo[1, None, s:]   # rows p-1 and p+1
        if 2 * s >= chunk_min:
            lam1, (q1, lo1, hi1, pm1, pp1) = rank1_merge_apply_parts(
                dm[None], z1[None], one,
                ((q_loc[None], half_off), (lo_left[None], 0),
                 (hi_right[None], s), (pm1[None], 0), (pp1[None], s)),
                panel=chunk_panel)
            # merge 2: u2 = f·δ_{p-1} + h·δ_{p+1} in the merged basis
            z2 = f * pm1[0, 0] + h * pp1[0, 0]
            lam, (q_loc, rows_lo, rows_hi) = rank1_merge_apply_parts(
                lam1, z2[None], one, ((q1, 0), (lo1, 0), (hi1, 0)),
                panel=chunk_panel)
            w, q_loc, rows_lo, rows_hi = lam[0], q_loc[0], rows_lo[0], \
                rows_hi[0]
        else:
            core = rank1_merge_core(dm[None], z1[None], one)
            c1 = core.unsorted_c()[0]
            q_loc = q_loc @ c1[half_off:half_off + s].to(vec_dtype)
            lo1, hi1 = lo_left @ c1[:s], hi_right @ c1[s:]
            z2 = f * (pm1 @ c1[:s])[0] + h * (pp1 @ c1[s:])[0]
            core = rank1_merge_core(core.lam, z2[None], one)
            c2 = core.unsorted_c()[0]
            q_loc = q_loc @ c2.to(vec_dtype)
            w, rows_lo, rows_hi = core.lam[0], lo1 @ c2, hi1 @ c2
    return w, q_loc


def comm_model_dc_band(n_pad: int, p: int, vec_itemsize: int) -> CommStats:
    """CommStats of one distributed band-2 tree: phase 2's three group
    sums a level (the eigenvalues, the first two and the last two rows of
    the merged block, f64) and the final reshard, counted as
    ``dc_dist.comm_model_dc`` counts it."""
    st = CommStats()
    if p > 1 and _is_pow2(p):
        for t in range(int(np.log2(p))):
            width = (n_pad // p) << (t + 1)
            st.record("reduce", 5 * width * 8, 3)
    st.record("redist", n_pad * n_pad * vec_itemsize, 1)
    return st


def solve_band2_dist(d, e1, e2, mesh, big_n: int, nvec: int, vec_dtype,
                     leaf: int = LEAF, chunk_min: int = None,
                     chunk_panel: int = None):
    """Distributed P = S·diag(w)·Sᵀ of the pentadiagonal (d, e1, e2), S
    laid out for the back-transform (JAX ``solve_band2_dist``,
    dc_band_dist.py:178; the Z layout of ``dc_dist.solve_tridiag_dist``).

    d (n,), e1 (n−1,), e2 (n−2,), the same on every rank.  Returns (w (n,)
    f64, the same on every rank; this rank's (big_n/px, ⌈nvec/py⌉) block
    of S's first nvec columns, zero outside the n × nvec matrix).  Joins at
    least `chunk_min` wide (default ``dc_band._LEVEL_CHUNK_MIN``) build
    their transforms in panels of `chunk_panel` columns (default
    ``dc_band._LEVEL_CHUNK_PANEL``).  Non-finite input gives NaN."""
    n = d.shape[0]
    px, py = mesh.shape
    p = px * py
    m_x, nv_y = big_n // px, -(-nvec // py)
    dev = d.device
    if not bool(torch.isfinite(d).all() & torch.isfinite(e1).all()
                & torch.isfinite(e2).all()):
        return (torch.full((n,), float("nan"), dtype=F64, device=dev),
                torch.full((m_x, nv_y), float("nan"), dtype=vec_dtype,
                           device=dev))
    if not (_is_pow2(p) and _is_pow2(px) and _is_pow2(py)) or p == 1:
        # the replicated fallback (FS non-member ranks, FS_libs.F90:183)
        w, s = dc_band.solve_band2_dc(d, e1, e2, leaf=leaf,
                                      vec_dtype=vec_dtype)
        return w, _block(s, mesh, n, nvec, m_x, nv_y)
    n_pad, _, rloc = _tree_sizes(n, p, leaf)
    d_mod, e1_mod, e2_pad, coefs = dc_band._prepare(d, e1, e2, n_pad, leaf)
    w, q_loc = _dc_band_tree_shard(
        d_mod, e1_mod, e2_pad, coefs, mesh, leaf, rloc, vec_dtype,
        dc_band._LEVEL_CHUNK_MIN if chunk_min is None else chunk_min,
        dc_band._LEVEL_CHUNK_PANEL if chunk_panel is None else chunk_panel)
    return w[:n], _tree_blocks(q_loc, mesh, n, nvec, big_n)
