"""Tree divide & conquer for the symmetric tridiagonal eigenproblem.

Counterpart of ``eigenexa_tpu/solvers/dc_tree.py`` (reference: dc2_FS.F:75
→ FS_EDC.F90:70 → FS_PDLAED0.F90:62 binary merge tree):

* bottom-up batched tree: the problem is padded to leaf·2^L and every
  level is ONE batched merge over all pairs (a Python loop over levels —
  the natural eager form; the JAX package's fused/level program split is a
  TPU compile limit);
* mask-based deflation (ops/secular.py): deflated coordinates keep their
  slot as exact unit eigenvector columns;
* mixed precision: d/z/λ and the secular work in float64 on every device,
  leaves from ``torch.linalg.eigh`` in float64, the O(m³) eigenvector GEMM
  cascade in the requested vector dtype;
* padding coordinates carry zero coupling, so they deflate exactly at
  every level and fall out of the final slice;
* a merge at least ``_LEVEL_CHUNK_MIN`` wide never builds its (2s)²
  transform: ``_merge_level_chunked`` builds it ``_LEVEL_CHUNK_PANEL``
  columns at a time and multiplies each panel into the new eigenvectors
  at once (``ops/secular.rank1_merge_apply_parts``; the JAX package's
  ``_merge_level_chunked``, dc_tree.py:181, with its chunk width and a
  panel of the card's own, :222-223).
  The levels below keep ``rank1_merge_core``.  With the top levels chunked,
  the level below them sets the D&C's memory peak.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eigenexa_tpu_torch.ops.secular import (rank1_merge_apply_parts,
                                            rank1_merge_core)
from eigenexa_tpu_torch.utils import profiler

F64 = torch.float64
# merges at least this wide build C in column panels of _LEVEL_CHUNK_PANEL
# (module attributes, read at each level).  The width is the JAX package's;
# panels of 2048 took 5–11% less D&C time than its 1024 in every warm run
# at Frank n = 16384 and 32768 f32, in both trees, at the same peak
# (tools/dc_chunk.py; NVIDIA H100 80GB HBM3, 700 W)
_LEVEL_CHUNK_MIN = 16384
_LEVEL_CHUNK_PANEL = 2048


def _pad_sizes(n: int, leaf: int) -> Tuple[int, int]:
    """Smallest leaf·2^L ≥ n, and L."""
    levels = 0
    m = leaf
    while m < n:
        m *= 2
        levels += 1
    return m, levels


def _leaf_eigh(d_blocks, e_blocks):
    """Batched dense eigh of the (B, s) leaf tridiagonals."""
    t = (torch.diag_embed(d_blocks) + torch.diag_embed(e_blocks, 1)
         + torch.diag_embed(e_blocks, -1))
    return torch.linalg.eigh(t)


def _merge_level(d, q, row0, row1, rho, sgn, vec_dtype):
    """One tree level: merge block pairs (2b, 2b+1).

    d: (B, s) sorted per block (f64); q: (B, s, s) in vec_dtype;
    row0/row1: (B, s) first/last rows of each block's eigenvectors, kept in
    f64 so the rank-1 z-vectors keep full working precision; rho: (B/2,)
    couplings ≥ 0; sgn: (B/2,) sign applied to the right z.
    Returns (d', q', row0', row1') with B/2 blocks of size 2s.
    """
    bsz, s = d.shape
    h = bsz // 2
    q2 = q.reshape(h, 2, s, s)
    r0 = row0.reshape(h, 2, s)
    r1 = row1.reshape(h, 2, s)
    z = torch.cat([r1[:, 0], sgn[:, None] * r0[:, 1]], dim=1)
    with profiler.span("dc.secular"):
        core = rank1_merge_core(d.reshape(h, 2 * s), z, rho)
    lam = core.lam
    # rows of c back to pre-sort coordinate order (a gather with the
    # inverse permutation), then the block-diagonal basis in two
    # half-height GEMMs (dlaed3 shape)
    c_unsorted = core.unsorted_c()
    del core
    cu = c_unsorted.to(vec_dtype)
    top = q2[:, 0] @ cu[:, :s, :]
    bot = q2[:, 1] @ cu[:, s:, :]
    # propagate boundary rows in f64 (O(m²))
    row0_new = (r0[:, 0, None, :] @ c_unsorted[:, :s, :])[:, 0]
    row1_new = (r1[:, 1, None, :] @ c_unsorted[:, s:, :])[:, 0]
    return lam, torch.cat([top, bot], dim=1), row0_new, row1_new


def _merge_level_chunked(d, q, row0, row1, rho, sgn, vec_dtype,
                         panel: int):
    """:func:`_merge_level` with C built `panel` columns at a time
    (``rank1_merge_apply_parts``): the new eigenvectors are written into
    one (B/2, 2s, 2s) buffer panel by panel, and no transient is larger
    than (B/2, 2s, panel) in f64 (reference: ``_merge_level_chunked``,
    eigenexa_tpu/solvers/dc_tree.py:181)."""
    bsz, s = d.shape
    h = bsz // 2
    q2 = q.reshape(h, 2, s, s)
    r0 = row0.reshape(h, 2, s)
    r1 = row1.reshape(h, 2, s)
    z = torch.cat([r1[:, 0], sgn[:, None] * r0[:, 1]], dim=1)
    out = torch.empty((h, 2 * s, 2 * s), dtype=vec_dtype, device=q.device)
    with profiler.span("dc.secular"):
        lam, (_, _, row0_new, row1_new) = rank1_merge_apply_parts(
            d.reshape(h, 2 * s), z, rho,
            ((q2[:, 0], 0), (q2[:, 1], s), (r0[:, 0, None, :], 0),
             (r1[:, 1, None, :], s)),
            panel=panel, outs=(out[:, :s], out[:, s:], None, None))
    return lam, out, row0_new[:, 0], row1_new[:, 0]


def solve_tridiag_dc(d: torch.Tensor, e: torch.Tensor, leaf: int = 32,
                     vec_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition T = S·diag(w)·Sᵀ of the tridiagonal (d, e).

    Returns ascending w (n,) in float64 and S (n, n) in ``vec_dtype``
    (default d.dtype).  Non-finite input returns NaN (the reference's
    NaN-poisoning contract, src/eigen_s.F:156-160) instead of raising.
    """
    n = d.shape[0]
    dev = d.device
    vec_dtype = vec_dtype or d.dtype
    if n == 1:
        return d.to(F64), torch.ones((1, 1), dtype=vec_dtype, device=dev)
    d = d.to(F64)
    e = e.to(F64)
    if not bool(torch.isfinite(d).all() & torch.isfinite(e).all()):
        return (torch.full((n,), float("nan"), dtype=F64, device=dev),
                torch.full((n, n), float("nan"), dtype=vec_dtype,
                           device=dev))
    leaf = max(2, min(leaf, n))
    m, levels = _pad_sizes(n, leaf)

    # pad: decoupled ascending diagonal beyond n, SCALE-RELATIVE so pads do
    # not inflate the deflation tolerances of mixed real/pad merges
    span = d.abs().amax() + e.abs().amax()
    base = torch.clamp_min(span, torch.finfo(F64).tiny)
    d_pad = torch.cat(
        [d, 2.0 * base + (base / m) * torch.arange(m - n, dtype=F64,
                                                   device=dev)])
    e_pad = torch.cat([e, torch.zeros(m - n + 1, dtype=F64, device=dev)])

    # Cuppen cuts: boundary p couples (p-1, p) via e_pad[p-1]; subtract |e|
    # from both adjacent diagonals at every cut (each cut is used at
    # exactly one level)
    cuts = torch.arange(leaf, m, leaf, device=dev)
    rho_all = e_pad[cuts - 1].abs()
    d_mod = d_pad.clone()
    d_mod[cuts - 1] -= rho_all
    d_mod[cuts] -= rho_all

    nblk = m // leaf
    with profiler.span("dc.leaves"):
        e_idx = (torch.arange(nblk, device=dev)[:, None] * leaf
                 + torch.arange(leaf - 1, device=dev)[None, :])
        w, q = _leaf_eigh(d_mod.reshape(nblk, leaf), e_pad[e_idx])
        row0 = q[:, 0, :]            # f64 boundary rows before the cast
        row1 = q[:, -1, :]
        q = q.to(vec_dtype)

    # level ℓ joins blocks of size leaf·2^ℓ at cut positions leaf·2^ℓ·(2b+1)
    for lvl in range(levels):
        s = leaf * (2 ** lvl)
        with profiler.span("dc.level"):
            e_cut = e_pad[torch.arange(s, m, 2 * s, device=dev) - 1]
            sgn = torch.where(e_cut >= 0, 1.0, -1.0).to(F64)
            if 2 * s >= _LEVEL_CHUNK_MIN:
                w, q, row0, row1 = _merge_level_chunked(
                    w, q, row0, row1, e_cut.abs(), sgn, vec_dtype,
                    _LEVEL_CHUNK_PANEL)
            else:
                w, q, row0, row1 = _merge_level(w, q, row0, row1,
                                                e_cut.abs(), sgn, vec_dtype)

    return w.reshape(m)[:n], q.reshape(m, m)[:n, :n]
