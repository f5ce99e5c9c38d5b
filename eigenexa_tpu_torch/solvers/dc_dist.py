"""Distributed divide & conquer for the reduced tridiagonal problem
(counterpart of ``eigenexa_tpu/solvers/dc_dist.py``; reference: the FS
merge tree src/FS_PDLAED0.F90:62, its sub-grids src/FS_dividing.F90:22-55,
the group z/d reduction src/FS_REDUCE_ZD.F90:98, the secular solve and
eigenvector GEMM src/FS_PDLAED3.F90:281,646-765, and the final
redistribution src/FS2eigen_PDLASRT.F90:237).

The JAX package's design, one rank at a time:

* rows never move: each of the P = px·py ranks owns the contiguous block
  of n_pad/P tridiagonal coordinates (eigenvector rows) of its flat rank
  ix·py + iy;
* phase 1 ("local"): the leaves and every merge level inside a rank's
  block, with no communication (the port's ``dc_tree._leaf_eigh`` and
  ``_merge_level`` on the rank's rows, leaves of 32);
* phase 2 ("group"): log2 P levels, each joining blocks of 2^t ranks; the
  only communication is the group allreduce of the O(m) eigenvalues,
  z vector and boundary rows (``collectives.grouped_allreduce``), and every
  rank of a group solves the same secular equation and multiplies its own
  rows into the merged basis (``rank1_merge_core``; at least
  ``dc_tree._LEVEL_CHUNK_MIN`` wide, in column panels of
  ``dc_tree._LEVEL_CHUNK_PANEL``, ``rank1_merge_apply_parts``).

P must be a power of two, and so px and py (the FS subsystem's
constraint, src/FS_libs.F90:183); other meshes and P = 1 take the
replicated single-device tree on every rank, as FS non-member ranks sit
out.  The tree's row blocks become the ('x', 'y') blocks of the
back-transform by one all_gather along 'y': the rows of grid row ix are the
row blocks of flat ranks ix·py … ix·py + py − 1, its 'y' group.  That holds
where the tree's padded size equals the solve's N; otherwise a second
all_gather, along 'x', of this rank's columns brings the rows it needs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from eigenexa_tpu_torch.ops.secular import (rank1_merge_apply_parts,
                                            rank1_merge_core)
from eigenexa_tpu_torch.parallel.collectives import (CommStats, all_gather,
                                                     grouped_allreduce)
from eigenexa_tpu_torch.solvers import dc_tree
from eigenexa_tpu_torch.solvers.dc_tree import (_leaf_eigh, _merge_level,
                                                _merge_level_chunked,
                                                _pad_sizes, solve_tridiag_dc)

F64 = torch.float64
LEAF = 32   # the port's leaves: eigh, 32 wide (solver._DC_LEAF)


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def _tree_sizes(n: int, p: int, leaf: int) -> Tuple[int, int, int]:
    """(n_pad, levels, rloc): n_pad = leaf·2^L ≥ max(n, leaf·p)."""
    m, levels = _pad_sizes(max(n, leaf * p), leaf)
    return m, levels, m // p


def _prepare_tree(d, e, n_pad: int, leaf: int):
    """Padding and the Cuppen cut modification, the convention of
    ``dc_tree.solve_tridiag_dc`` (a scale-relative pad ramp, |e|
    subtracted on both sides of every cut), in f64."""
    n = d.shape[0]
    dev = d.device
    d, e = d.to(F64), e.to(F64)
    span = d.abs().amax() + (e.abs().amax() if n > 1 else 0.0)
    base = torch.clamp_min(span, torch.finfo(F64).tiny)
    d_pad = torch.cat([d, 2.0 * base + (base / n_pad)
                       * torch.arange(n_pad - n, dtype=F64, device=dev)])
    e_pad = torch.cat([e, torch.zeros(n_pad - n + 1, dtype=F64, device=dev)])
    cuts = torch.arange(leaf, n_pad, leaf, device=dev)
    rho = e_pad[cuts - 1].abs()
    d_mod = d_pad.clone()
    d_mod[cuts - 1] -= rho
    d_mod[cuts] -= rho
    return d_mod, e_pad


def _sign(x):
    return torch.where(x >= 0, 1.0, -1.0).to(F64)


def _dc_tree_shard(d_mod, e_pad, mesh, leaf: int, rloc: int, vec_dtype):
    """One rank's part of the merge tree (JAX ``_dc_tree_shard``,
    dc_dist.py:82).  d_mod, e_pad (n_pad,) the same on every rank.
    Returns (w (n_pad,), the same on every rank; q_loc (rloc, n_pad), this
    rank's rows of the eigenvectors)."""
    p = mesh.size
    r = mesh.flat
    g_off = r * rloc
    dev = d_mod.device

    # ---- leaves (FS_PDLAED0.F90:178 local DSTEDC analogue) ----
    nblk = rloc // leaf
    e_idx = (g_off + torch.arange(nblk, device=dev)[:, None] * leaf
             + torch.arange(leaf - 1, device=dev)[None, :])
    w, q = _leaf_eigh(d_mod[g_off:g_off + rloc].reshape(nblk, leaf),
                      e_pad[e_idx])
    row0, row1 = q[:, 0, :], q[:, -1, :]
    q = q.to(vec_dtype)

    # ---- phase 1: the merge levels inside this rank's block ----
    s = leaf
    while s < rloc:
        e_cut = e_pad[g_off + s - 1 + torch.arange(0, rloc, 2 * s,
                                                   device=dev)]
        if 2 * s >= dc_tree._LEVEL_CHUNK_MIN:
            w, q, row0, row1 = _merge_level_chunked(
                w, q, row0, row1, e_cut.abs(), _sign(e_cut), vec_dtype,
                dc_tree._LEVEL_CHUNK_PANEL)
        else:
            w, q, row0, row1 = _merge_level(w, q, row0, row1, e_cut.abs(),
                                            _sign(e_cut), vec_dtype)
        s *= 2
    q_loc = q.reshape(rloc, rloc)
    w, row0, row1 = w.reshape(rloc), row0.reshape(rloc), row1.reshape(rloc)

    # ---- phase 2: the group levels (FS_PDLAED1.F90:84) ----
    for t in range(int(np.log2(p))):
        s = rloc << t                # child block width
        gsz = 1 << (t + 1)           # ranks of the merged block
        within = r % gsz
        left = within < gsz // 2
        half_off = 0 if left else s
        e_cut = e_pad[(r // gsz) * 2 * s + s - 1]
        rho = e_cut.abs()

        # z and d of the merged block (FS_PDLAEDZ + FS_REDUCE_ZD): the
        # leader of each half contributes, the group sum replicates
        lead = within in (0, gsz // 2)
        dz = torch.zeros((2, 2 * s), dtype=F64, device=dev)
        if lead:
            dz[0, half_off:half_off + s] = w
            dz[1, half_off:half_off + s] = (row1 if left
                                            else _sign(e_cut) * row0)
        dz = grouped_allreduce(dz, gsz, mesh)

        # the secular solve, the same on every rank of the group
        if 2 * s >= dc_tree._LEVEL_CHUNK_MIN:
            lam, (q_new, rows2) = rank1_merge_apply_parts(
                dz[0][None], dz[1][None], rho[None],
                ((q_loc[None], half_off),
                 (torch.stack([row0, row1])[None], half_off)),
                panel=dc_tree._LEVEL_CHUNK_PANEL)
            lam, q_loc, rows2 = lam[0], q_new[0], rows2[0]
        else:
            core = rank1_merge_core(dz[0][None], dz[1][None], rho[None])
            lam = core.lam[0]
            c_slice = core.unsorted_c()[0, half_off:half_off + s]
            del core
            q_loc = q_loc @ c_slice.to(vec_dtype)
            rows2 = torch.stack([row0, row1]) @ c_slice

        # the merged block's boundary rows, replicated over the group
        rows = torch.zeros((2, 2 * s), dtype=F64, device=dev)
        if within == 0:
            rows[0] = rows2[0]
        if within == gsz - 1:
            rows[1] = rows2[1]
        row0, row1 = grouped_allreduce(rows, gsz, mesh)
        w = lam
    return w, q_loc


def comm_model_dc(n_pad: int, p: int, wdt_itemsize: int,
                  vec_itemsize: int) -> CommStats:
    """CommStats of one distributed tree (the JAX package's model,
    dc_dist.py:191): phase 2's group reductions of z, d and the two
    boundary rows, and the final reshard."""
    st = CommStats()
    if p > 1 and _is_pow2(p):
        for t in range(int(np.log2(p))):
            gsz = 1 << (t + 1)
            width = (n_pad // p) * gsz
            steps = int(np.log2(gsz))
            st.record("reduce", 4 * width * wdt_itemsize * steps, 4 * steps)
    st.record("redist", n_pad * n_pad * vec_itemsize, 1)
    return st


def _block(s, mesh, n: int, nvec: int, m_x: int, nv_y: int,
           row_start: int = 0, col_start: int = 0):
    """This rank's (m_x, nv_y) block of S_pad: rows [ix·m_x, (ix+1)·m_x)
    and columns [iy·nv_y, (iy+1)·nv_y) of the (n, nvec) eigenvectors, zero
    outside them.  `s` holds S's rows from `row_start` on and its columns
    from `col_start` on."""
    out = torch.zeros((m_x, nv_y), dtype=s.dtype, device=s.device)
    r0, c0 = mesh.ix * m_x, mesh.iy * nv_y
    r1, c1 = min(r0 + m_x, n), min(c0 + nv_y, nvec)
    if r0 < r1 and c0 < c1:
        out[:r1 - r0, :c1 - c0] = s[r0 - row_start:r1 - row_start,
                                    c0 - col_start:c1 - col_start]
    return out


def solve_tridiag_dist(d, e, mesh, big_n: int, nvec: int, vec_dtype,
                       leaf: int = LEAF):
    """Distributed T = S·diag(w)·Sᵀ, S laid out for the back-transform
    (JAX ``solve_tridiag_dist``, dc_dist.py:230).

    d (n,), e (n−1,), the same on every rank.  Returns (w (n,) f64, the
    same on every rank; this rank's (big_n/px, ⌈nvec/py⌉) block of the
    (big_n, ·) matrix whose rows and columns [0, n) × [0, nvec) hold S's
    first nvec columns, zero elsewhere).  Non-finite input gives NaN."""
    n = d.shape[0]
    px, py = mesh.shape
    p = px * py
    m_x = big_n // px
    nv_y = -(-nvec // py)
    dev = d.device
    if not bool(torch.isfinite(d).all() & torch.isfinite(e).all()):
        return (torch.full((n,), float("nan"), dtype=F64, device=dev),
                torch.full((m_x, nv_y), float("nan"), dtype=vec_dtype,
                           device=dev))
    if not (_is_pow2(p) and _is_pow2(px) and _is_pow2(py)) or p == 1:
        # the replicated fallback (FS non-member ranks, FS_libs.F90:183)
        w, s = solve_tridiag_dc(d, e, leaf=leaf, vec_dtype=vec_dtype)
        return w, _block(s, mesh, n, nvec, m_x, nv_y)
    n_pad, _, rloc = _tree_sizes(n, p, leaf)
    d_mod, e_pad = _prepare_tree(d, e, n_pad, leaf)
    w, q_loc = _dc_tree_shard(d_mod, e_pad, mesh, leaf, rloc, vec_dtype)
    return w[:n], _tree_blocks(q_loc, mesh, n, nvec, big_n)


def _tree_blocks(q_loc, mesh, n: int, nvec: int, big_n: int):
    """This rank's (big_n/px, ⌈nvec/py⌉) block of the Z layout from the
    tree's rows: flat rank r holds rows [r·rloc, (r+1)·rloc) of the
    (n_pad, n_pad) eigenvectors, n_pad = P·rloc."""
    px, py = mesh.shape
    m_x, nv_y = big_n // px, -(-nvec // py)
    rloc = q_loc.shape[0]
    # grid row ix holds tree rows [ix·py·rloc, (ix+1)·py·rloc)
    rows = all_gather(q_loc, mesh, "y")
    if px * py * rloc == big_n:
        return _block(rows, mesh, n, nvec, m_x, nv_y,
                      row_start=mesh.ix * m_x)
    # the rows this rank needs lie in other grid rows' blocks: take this
    # rank's columns of its grid row's rows, and gather them along 'x'
    mine = _block(rows, mesh, n, nvec, py * rloc, nv_y,
                  row_start=mesh.ix * py * rloc)
    cols = all_gather(mine, mesh, "x")
    return _block(cols, mesh, n, nvec, m_x, nv_y, col_start=mesh.iy * nv_y)
