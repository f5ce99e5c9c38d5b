"""Divide & conquer for the symmetric PENTADIAGONAL eigenproblem: the D&C
stage of ``eigen_sx``.

Counterpart of ``eigenexa_tpu/solvers/dc_band.py`` (reference: dcx.F:81 →
MY_PDSxEDC, my_pdsxedc.F:27, half-bandwidth 2 → MY_PDLAED0, my_pdlaed0.F:18,
two rank-1 merges a join; leaves through LAPACK_EIGEN2, src/lapack_eigen.F).

Band-2 Cuppen: a cut at position p removes the three entries that cross
it, e1[p-1], e2[p-2] and e2[p-1].  Two symmetric rank-1 updates with
small-support vectors restore them,

    u1 = a·δ_{p-2} + b·δ_{p-1} + c·δ_p     (a·c = e2[p-2], b·c = e1[p-1])
    u2 = f·δ_{p-1} + h·δ_{p+1}             (f·h = e2[p-1])

so T = blockdiag(T1', T2') + u1·u1ᵀ + u2·u2ᵀ with the compensating
in-block changes applied up front.  Each join runs the rank-1 merge twice
(``ops/secular.rank1_merge_core``), the second z in the basis of the first.
Each block carries its first two and last two eigenvector rows in f64,
which is what the two z-vectors need.

The port's ``dc_tree`` conventions: f64 work dtype on every device (the JAX
package's f32 work dtype and ``n_iter=16`` are TPU workarounds), leaves
from one batched ``torch.linalg.eigh`` on the device, NaN poisoning of
non-finite input, and a gather with the inverse permutation in place of
JAX's ``.at[perm].set``.  A join at least ``_LEVEL_CHUNK_MIN`` wide takes
``_merge_level_band2_chunked`` (reference: dc_band.py:305, its constants
:400-401, with the card's panel of 2048): both merges build their
transforms in column panels, so the (2s)² C₁, C₂ and C₁·C₂ of
``_merge_level_band2`` are never held.  The JAX package's host path
(``_host_leaf_eigh_band2``) serves the TPU's f64 and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eigenexa_tpu_torch.ops.secular import (rank1_merge_apply_parts,
                                            rank1_merge_core)
from eigenexa_tpu_torch.solvers.dc_tree import _pad_sizes
from eigenexa_tpu_torch.utils import profiler

F64 = torch.float64
# the band-2 twins of dc_tree._LEVEL_CHUNK_MIN / _LEVEL_CHUNK_PANEL (the
# same measurement placed the panel)
_LEVEL_CHUNK_MIN = 16384
_LEVEL_CHUNK_PANEL = 2048


def _cut_vectors(e1_pad, e2_pad, p):
    """(a, b, c, f, h) of the two rank-1 restore vectors at each cut of
    ``p`` (reference: my_pdsxedc.F)."""
    th1 = e1_pad[p - 1]          # T[p-1, p]
    th2a = e2_pad[p - 2]         # T[p-2, p]
    th2b = e2_pad[p - 1]         # T[p-1, p+1]
    c = torch.sqrt(torch.hypot(th1, th2a))
    pos = c > 0
    safe = torch.where(pos, c, 1.0)
    a = torch.where(pos, th2a / safe, 0.0)
    b = torch.where(pos, th1 / safe, 0.0)
    f = torch.sqrt(th2b.abs())
    h = torch.where(th2b >= 0, f, -f)
    return a, b, c, f, h


def _leaf_eigh_band2(d_blocks, e1_blocks, e2_blocks):
    """Batched dense eigh of the (B, s) pentadiagonal leaves (the
    LAPACK_EIGEN2 analogue on the device)."""
    t = (torch.diag_embed(d_blocks)
         + torch.diag_embed(e1_blocks, 1) + torch.diag_embed(e1_blocks, -1)
         + torch.diag_embed(e2_blocks, 2) + torch.diag_embed(e2_blocks, -2))
    return torch.linalg.eigh(t)


def _merge_level_band2(w, q, rows_lo, rows_hi, a, b, c, f, h, vec_dtype):
    """One level: join block pairs (2i, 2i+1) with TWO rank-1 merges (the
    half-bandwidth-2 structure, reference: my_pdlaed0.F:18).

    w: (B, s) ascending per block, f64; q: (B, s, s) in vec_dtype;
    rows_lo / rows_hi: (B, 2, s) first two / last two eigenvector rows in
    f64; a … h: (B/2,) cut coefficients.  Returns (w', q', rows_lo',
    rows_hi') with B/2 blocks of size 2s."""
    bsz, s = w.shape
    half = bsz // 2
    q2 = q.reshape(half, 2, s, s)
    rl = rows_lo.reshape(half, 2, 2, s)   # [pair, block, row, s]
    rh = rows_hi.reshape(half, 2, 2, s)
    ones = torch.ones(half, dtype=F64, device=w.device)
    # merge 1: u1 = a·δ_{p-2} + b·δ_{p-1} + c·δ_p in pair coordinates,
    # p = s: the left block's last two rows, the right block's first
    z1 = torch.cat([a[:, None] * rh[:, 0, 0] + b[:, None] * rh[:, 0, 1],
                    c[:, None] * rl[:, 1, 0]], dim=1)
    with profiler.span("dc.secular"):
        core1 = rank1_merge_core(w.reshape(half, 2 * s), z1, ones)
    c1 = core1.unsorted_c()
    lam1 = core1.lam
    del core1
    # boundary rows through C1: left rows live in [:s], right rows in [s:]
    lo1 = rl[:, 0] @ c1[:, :s]                        # pair rows 0, 1
    hi1 = rh[:, 1] @ c1[:, s:]                        # rows 2s-2, 2s-1
    row_pm1 = (rh[:, 0, 1, None, :] @ c1[:, :s])[:, 0]   # row p-1
    row_pp1 = (rl[:, 1, 1, None, :] @ c1[:, s:])[:, 0]   # row p+1
    # merge 2: u2 = f·δ_{p-1} + h·δ_{p+1} in the merged basis
    z2 = f[:, None] * row_pm1 + h[:, None] * row_pp1
    with profiler.span("dc.secular"):
        core2 = rank1_merge_core(lam1, z2, ones)
    c2 = core2.unsorted_c()
    cu = (c1 @ c2).to(vec_dtype)
    del c1
    top = q2[:, 0] @ cu[:, :s]
    bot = q2[:, 1] @ cu[:, s:]
    del cu
    return (core2.lam, torch.cat([top, bot], dim=1), lo1 @ c2, hi1 @ c2)


def _merge_level_band2_chunked(w, q, rows_lo, rows_hi, a, b, c, f, h,
                               vec_dtype, panel: int):
    """:func:`_merge_level_band2` with both rank-1 merges built in column
    panels (``rank1_merge_apply_parts``; reference:
    ``_merge_level_band2_chunked``, eigenexa_tpu/solvers/dc_band.py:305).
    Merge 1 takes the two blocks, their boundary rows and the two coupling
    rows p − 1 and p + 1 as its parts; merge 2 then acts on the merged
    eigenvectors Q·C₁ in vec_dtype and on the boundary rows in f64."""
    bsz, s = w.shape
    half = bsz // 2
    q2 = q.reshape(half, 2, s, s)
    rl = rows_lo.reshape(half, 2, 2, s)   # [pair, block, row, s]
    rh = rows_hi.reshape(half, 2, 2, s)
    ones = torch.ones(half, dtype=F64, device=w.device)
    z1 = torch.cat([a[:, None] * rh[:, 0, 0] + b[:, None] * rh[:, 0, 1],
                    c[:, None] * rl[:, 1, 0]], dim=1)
    q1 = torch.empty((half, 2 * s, 2 * s), dtype=vec_dtype, device=q.device)
    with profiler.span("dc.secular"):
        lam1, (_, _, lo1, hi1, pm1, pp1) = rank1_merge_apply_parts(
            w.reshape(half, 2 * s), z1, ones,
            ((q2[:, 0], 0), (q2[:, 1], s), (rl[:, 0], 0), (rh[:, 1], s),
             (rh[:, 0, 1, None, :], 0), (rl[:, 1, 1, None, :], s)),
            panel=panel, outs=(q1[:, :s], q1[:, s:], None, None, None,
                               None))
    z2 = f[:, None] * pm1[:, 0] + h[:, None] * pp1[:, 0]
    with profiler.span("dc.secular"):
        lam2, (q_new, lo2, hi2) = rank1_merge_apply_parts(
            lam1, z2, ones, ((q1, 0), (lo1, 0), (hi1, 0)), panel=panel)
    return lam2, q_new, lo2, hi2


def solve_band2_dc(d: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                   leaf: int = 32, vec_dtype=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition T = S·diag(w)·Sᵀ of the pentadiagonal
    (d, e1, e2).

    Returns ascending w (n,) in float64 and S (n, n) in ``vec_dtype``
    (default d.dtype).  Non-finite input returns NaN (the reference's
    NaN-poisoning contract, src/eigen_s.F:156-160) instead of raising.
    """
    n = d.shape[0]
    dev = d.device
    vec_dtype = vec_dtype or d.dtype
    if n == 1:
        return d.to(F64), torch.ones((1, 1), dtype=vec_dtype, device=dev)
    d, e1, e2 = d.to(F64), e1.to(F64), e2.to(F64)
    if not bool(torch.isfinite(d).all() & torch.isfinite(e1).all()
                & torch.isfinite(e2).all()):
        return (torch.full((n,), float("nan"), dtype=F64, device=dev),
                torch.full((n, n), float("nan"), dtype=vec_dtype,
                           device=dev))
    leaf = max(4, min(leaf, n))
    m, _ = _pad_sizes(n, leaf)
    d_mod, e1_mod, e2_pad, coefs = _prepare(d, e1, e2, m, leaf)
    w, q, _, _ = _solve_blocks(d_mod, e1_mod, e2_pad, coefs, 0, m, leaf,
                               vec_dtype, _LEVEL_CHUNK_MIN,
                               _LEVEL_CHUNK_PANEL)
    return w[:n], q[:n, :n]


def _prepare(d, e1, e2, m: int, leaf: int):
    """The tree's input of size m (f64): (d, e1, e2) padded with a
    decoupled, scale-relative ascending diagonal (see dc_tree), and every
    cut at leaf, 2·leaf, … < m made up front, each boundary cut exactly
    once across the levels.  Returns (d_mod, e1_mod, e2_pad, (a, b, c, f,
    h) at each cut)."""
    n = d.shape[0]
    dev = d.device
    d, e1, e2 = d.to(F64), e1.to(F64), e2.to(F64)
    span = d.abs().amax()
    if n > 1:
        span = span + e1.abs().amax()
    if n > 2:
        span = span + e2.abs().amax()
    base = torch.clamp_min(span, torch.finfo(F64).tiny)
    d_pad = torch.cat(
        [d, 2.0 * base + (base / m) * torch.arange(m - n, dtype=F64,
                                                   device=dev)])
    e1_pad = torch.cat([e1, d.new_zeros(m - n + 1)])
    e2_pad = torch.cat([e2, d.new_zeros(m - n + 2)])
    cuts = torch.arange(leaf, m, leaf, device=dev)
    a_all, b_all, c_all, f_all, h_all = _cut_vectors(e1_pad, e2_pad, cuts)
    d_mod = d_pad.clone()
    d_mod[cuts - 2] -= a_all * a_all
    d_mod[cuts - 1] -= b_all * b_all + f_all * f_all
    d_mod[cuts] -= c_all * c_all
    d_mod[cuts + 1] -= h_all * h_all
    e1_mod = e1_pad.clone()
    e1_mod[cuts - 2] -= a_all * b_all
    return d_mod, e1_mod, e2_pad, (a_all, b_all, c_all, f_all, h_all)


def _solve_blocks(d_mod, e1_mod, e2_pad, coefs, g0: int, size: int,
                  leaf: int, vec_dtype, chunk_min: int, chunk_panel: int):
    """The leaves and every merge level of the rows [g0, g0 + size) of the
    prepared tree (``_prepare``), size = leaf·2^k.  Returns (w (size,)
    ascending, f64; its eigenvectors (size, size) in vec_dtype; their first
    two and last two rows (2, size) each, f64).  A join at least
    `chunk_min` wide takes the panel-chunked merges."""
    dev = d_mod.device
    nblk = size // leaf
    with profiler.span("dc.leaves"):
        first = g0 + torch.arange(nblk, device=dev)[:, None] * leaf
        w, q = _leaf_eigh_band2(
            d_mod[g0:g0 + size].reshape(nblk, leaf),
            e1_mod[first + torch.arange(leaf - 1, device=dev)],
            e2_pad[first + torch.arange(leaf - 2, device=dev)])
        rows_lo = q[:, :2, :]          # f64 boundary rows before the cast
        rows_hi = q[:, -2:, :]
        q = q.to(vec_dtype)

    # level ℓ joins blocks of leaf·2^ℓ at the cuts g0 + leaf·2^ℓ·(2i+1)
    s = leaf
    while s < size:
        with profiler.span("dc.level"):
            ci = (torch.arange(g0 + s, g0 + size, 2 * s, device=dev) // leaf
                  - 1)
            level = tuple(x[ci] for x in coefs)
            if 2 * s >= chunk_min:
                w, q, rows_lo, rows_hi = _merge_level_band2_chunked(
                    w, q, rows_lo, rows_hi, *level, vec_dtype, chunk_panel)
            else:
                w, q, rows_lo, rows_hi = _merge_level_band2(
                    w, q, rows_lo, rows_hi, *level, vec_dtype)
        s *= 2
    return (w.reshape(size), q.reshape(size, size),
            rows_lo.reshape(2, size), rows_hi.reshape(2, size))
