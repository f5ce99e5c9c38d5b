"""Batched secular-equation machinery for divide & conquer.

Counterpart of ``eigenexa_tpu/ops/secular.py`` (reference: FS_PDLAED2.F90
deflation, FS_PDLAED3.F90 DLAED4 secular roots + eigenvector assembly).
Every function takes a leading batch dimension of merges (the JAX package
vmaps a single-merge function instead); each merge has static size m with
mask-based deflation.  Secular work is float64 on every device (the H100
has native f64; the JAX package's f32 work dtype is a TPU workaround).

Components:
  * close-eigenvalue deflation as per-run Householder rotations
    (dlaed2's Givens chains, masked);
  * a bracketed "middle way" secular solver, all roots in parallel, in the
    shift-and-offset (σ, μ) representation (the dlaed4 contract);
  * Gu–Eisenstat ẑ recomputation, which keeps the eigenvectors orthogonal
    without reorthogonalization, with on-pole demotion.

Reproducibility: the JAX package's ``segment_sum`` becomes a masked sum
over the same-run mask, and the run rotation a batched GEMM — no
``index_add_``/``scatter_add_``, whose float atomics on CUDA would sum in
a different order from run to run.  The runs are contiguous (the leaders
are non-decreasing), so the mask is block diagonal; it is taken only over
the row tiles that hold a run of two or more (one (m, m) tile in
:func:`rank1_merge_core`, tiles of a panel's width in
:func:`rank1_merge_apply_parts`).

Two forms of a merge:

* :func:`rank1_merge_core` builds the whole (B, m, m) transform C, with
  (B, m, m) secular intermediates — the form of every level below the top
  of a large tree;
* :func:`rank1_merge_apply_parts` never builds C (the JAX package's form
  for the top merges of n ≥ 16384, reference: FS_PDLAED3.F90:646-765's
  pipelined panels).  The roots are solved a panel of roots at a time,
  ẑ a panel of coordinates at a time (each ẑ_j still one product over
  all roots, as in the unchunked form; the JAX package chunks over the
  roots instead), and C a panel of final columns at a time, each panel
  multiplied into the callers' row blocks at once.  No transient is
  larger than (B, m, panel), the same-run mask's tiles included.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

F64 = torch.float64
# Smallest magnitude treated as nonzero — kept at the JAX package's value
# for parity (solver inputs are pre-scaled into the safe range).
TINY = 1e-30
# Secular iterations: the f64 work dtype's count in the JAX package (its cap
# at 16 applies only to the TPU's f32 work dtype).
N_ITER = 40


class MergeCore(NamedTuple):
    """Result of a batch of rank-1 merges in the sorted-coordinate basis."""
    lam: torch.Tensor     # (B, m) merged eigenvalues, ascending
    c: torch.Tensor       # (B, m, m) basis transform: Q_new = Q_sorted @ c
    perm: torch.Tensor    # (B, m) sort permutation applied to coordinates

    def unsorted_c(self) -> torch.Tensor:
        """c with its rows back in pre-sort coordinate order, so that
        Q_new = Q @ c for Q in the merge's own coordinates: a gather with
        the inverse permutation (JAX: ``.at[perm, :].set(c)``)."""
        bsz, m = self.perm.shape
        inv_perm = torch.argsort(self.perm, dim=1)
        return torch.gather(self.c, 1,
                            inv_perm[:, :, None].expand(bsz, m, m))


def _arange(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(m, device=like.device)


def _run_leaders(d: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """Group sorted d (B, m) into runs of near-equal values (gap ≤ tol);
    return the per-coordinate index of its run's leader (non-decreasing)."""
    bsz, m = d.shape
    gap_big = torch.cat(
        [torch.ones((bsz, 1), dtype=torch.bool, device=d.device),
         (d[:, 1:] - d[:, :-1]) > tol[:, None]], dim=1)
    tagged = torch.where(gap_big, _arange(m, d), 0)
    return torch.cummax(tagged, dim=1).values


def _run_ends(leaders: torch.Tensor) -> torch.Tensor:
    """Per-coordinate index of the last coordinate of its run."""
    bsz, m = leaders.shape
    idx = _arange(m, leaders)
    starts = torch.where(idx == leaders, idx, m)
    nxt = torch.flip(torch.cummin(torch.flip(starts, [1]), dim=1).values,
                     [1])                           # first start >= i
    return torch.cat([nxt[:, 1:], torch.full((bsz, 1), m,
                                             device=leaders.device)],
                     dim=1) - 1


def _run_tiles(leaders: torch.Tensor, ends: torch.Tensor, tile: int):
    """The row tiles [a, a + tile) of the merges that hold a coordinate of
    a run of two or more, each with the columns lo:hi of every run it
    touches, over the batch: [(a, b, lo, hi)].  Outside them every
    coordinate is a run of its own.  `tile` divides m; one host
    synchronization."""
    bsz, m = leaders.shape
    multi = (ends > leaders).reshape(bsz, m // tile, tile).any(dim=2)
    bounds = torch.stack([multi.any(dim=0).to(leaders.dtype),
                          leaders[:, ::tile].amin(dim=0),
                          ends[:, tile - 1::tile].amax(dim=0) + 1], dim=1)
    return [(a, a + tile, lo, hi) for a, (any_multi, lo, hi)
            in zip(range(0, m, tile), bounds.tolist()) if any_multi]


def _same_run(leaders, a: int, b: int, lo: int, hi: int) -> torch.Tensor:
    """(B, b − a, hi − lo) mask: coordinate i of rows a:b and j of columns
    lo:hi belong to the same run."""
    return leaders[:, a:b, None] == leaders[:, None, lo:hi]


def _run_reduce(x, leaders, tiles, op: str):
    """Per-coordinate sum (``op`` "sum", the JAX ``segment_sum(x,
    leaders)[leaders]``) or max ("amax") of x (B, m) over its run,
    atomic-free: a masked sum over the same-run mask of each tile of
    :func:`_run_tiles`."""
    out = x.clone()
    for a, b, lo, hi in tiles:
        vals = torch.where(_same_run(leaders, a, b, lo, hi),
                           x[:, None, lo:hi], 0.0)
        out[:, a:b] = vals.sum(dim=2) if op == "sum" else vals.amax(dim=2)
    return out


def _rotate_runs(d, z, tol, tile: int):
    """Per-run Householder rotation concentrating each run's z-weight into
    its leader.  Returns (z_new, u_hat, leaders, tiles): the rotation is
    G = I − 2·Σ_r û_r·û_rᵀ with disjoint-support û_r (apply with
    :func:`apply_run_rotation`); ``tiles`` are the row tiles of `tile`
    coordinates (:func:`_run_tiles`) over which the run sums take the mask,
    one (B, m, m) mask with tile = m."""
    m = z.shape[1]
    leaders = _run_leaders(d, tol)
    ends = _run_ends(leaders)
    tiles = _run_tiles(leaders, ends, tile)
    singleton = ends == leaders
    is_leader = _arange(m, z) == leaders
    norm_r = torch.sqrt(_run_reduce(z * z, leaders, tiles, "sum"))
    z_lead = torch.gather(z, 1, leaders)
    sgn = torch.where(z_lead >= 0, 1.0, -1.0).to(z.dtype)
    u = z + torch.where(is_leader, sgn * norm_r, 0.0)
    u = torch.where(singleton, 0.0, u)
    # normalize per run with max-abs pre-scaling: a run of uniformly tiny
    # z's must still yield an exactly-unit û, or G is not orthogonal
    u_max = _run_reduce(u.abs(), leaders, tiles, "amax")
    u_sc = u / torch.where(u_max > 0, u_max, 1.0)
    u_n2 = _run_reduce(u_sc * u_sc, leaders, tiles, "sum")
    u_hat = u_sc / torch.sqrt(torch.where(u_n2 > 0, u_n2, 1.0))
    z_new = torch.where(singleton, z,
                        torch.where(is_leader, -sgn * norm_r, 0.0))
    return z_new, u_hat, leaders, tiles


def apply_run_rotation(mat, u_hat, leaders, tiles):
    """M ← G·M with G = I − 2·Σ_r û_r·û_rᵀ (rows of M (B, m, k) are
    coordinates), a row tile at a time: each tile's rows from one batched
    GEMM against its block of W[i, j] = û_j·[same run] over the columns
    of its runs — fixed summation order, no atomics.  Rows outside the
    tiles are M's own (û is 0 there), and without tiles M itself returns."""
    pieces, row = [], 0
    for a, b, lo, hi in tiles:
        w = torch.where(_same_run(leaders, a, b, lo, hi),
                        u_hat[:, None, lo:hi], 0.0)
        pieces += [mat[:, row:a]] * (row < a) + [
            mat[:, a:b] - 2.0 * u_hat[:, a:b, None] * torch.bmm(
                w, mat[:, lo:hi])]
        row = b
    pieces += [mat[:, row:]] * (row < mat.shape[1])
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def _secular_next_active(active: torch.Tensor) -> torch.Tensor:
    """Per-coordinate index of the next active coordinate (> self); m+1
    when none.  (B, m) bool -> (B, m) int64."""
    bsz, m = active.shape
    tagged = torch.where(active, _arange(m, active), m + 1)
    suf = torch.flip(torch.cummin(torch.flip(tagged, [1]), dim=1).values,
                     [1])
    return torch.cat([suf[:, 1:], torch.full((bsz, 1), m + 1,
                                             device=active.device)], dim=1)


def _secular_roots(d, z2, rho, active, roots: slice = slice(None)):
    """Roots of 1 + ρ·Σ_j z_j²/(d_j − λ) for every merge of the batch, all
    in parallel.  d, z2, active: (B, m); rho: (B,).

    Root i (active) lives in (d_i, next-active d_i').  Returns
    (shift_d σ, mu, d1) with λ_i = σ_i + μ_i and d1[b, j, i] = d_j − σ_i —
    the cancellation-free representation dlaed4 mandates.  ``roots``
    restricts the solve to the roots at those sorted coordinates (the
    JAX package's ``ridx``, a contiguous panel here): every per-root array
    is then (B, p) and every matrix (B, m, p).
    """
    bsz, m = d.shape
    idx = _arange(m, d)
    rho_c = rho[:, None]
    nxt = _secular_next_active(active)[:, roots]
    zA = torch.where(active, z2, 0.0)
    sumz2 = zA.sum(dim=1, keepdim=True)
    # scale-relative slack: λ_max < d_max + ρ‖z‖² strictly
    slack = torch.clamp_min(rho_c * sumz2, TINY)

    a = d[:, roots]
    has_next = nxt <= m
    d_next = torch.gather(d, 1, torch.clamp(nxt, 0, m - 1))
    b = torch.where(has_next, d_next, a + rho_c * sumz2 + slack)

    def f_at(lam):
        delta = d[:, :, None] - lam[:, None, :]
        inv = torch.where(delta.abs() > 0, 1.0 / delta, 0.0)
        return 1.0 + rho_c * (zA[:, :, None] * inv).sum(dim=1)

    mid = 0.5 * (a + b)
    f_mid = f_at(mid)
    # the last active root's upper bound is synthetic (no pole there): the
    # two-pole model needs the shift on a true pole, so shift at d_i
    take_lo = (f_mid >= 0.0) | ~has_next
    shift_d = torch.where(take_lo, a, b)
    lo = torch.where(take_lo, torch.where(f_mid >= 0, 0.0, mid - a), mid - b)
    hi = torch.where(take_lo, torch.where(f_mid >= 0, mid - a, b - a), 0.0)

    d1 = d[:, :, None] - shift_d[:, None, :]        # (B, m_j, m_i)

    # dlaed4 "middle way": psi (poles at or below d_i) and phi (above),
    # each modelled by one pole matched to value and derivative
    p1 = a - shift_d
    p2 = torch.where(has_next, d_next - shift_d, 2.0 * (b - shift_d))
    low_mask = idx[:, None] <= idx[None, roots]     # j <= i : psi part
    z_col = zA[:, :, None]
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)

    mu = 0.5 * (lo + hi)
    for _ in range(N_ITER):
        delta = d1 - mu[:, None, :]
        inv = torch.where(delta.abs() > TINY, 1.0 / delta, 0.0)
        t = z_col * inv
        t2 = t * inv
        psi = rho_c * torch.where(low_mask, t, 0.0).sum(dim=1)
        psip = rho_c * torch.where(low_mask, t2, 0.0).sum(dim=1)
        phi = rho_c * torch.where(low_mask, 0.0, t).sum(dim=1)
        phip = rho_c * torch.where(low_mask, 0.0, t2).sum(dim=1)
        f = 1.0 + psi + phi
        fp = psip + phip
        root_above = f < 0.0          # f increasing in lambda
        lo = torch.where(root_above, mu, lo)
        hi = torch.where(root_above, hi, mu)
        g1 = p1 - mu
        g2 = p2 - mu
        s_w = psip * g1 * g1
        c1 = psi - psip * g1
        s_u = torch.where(has_next, phip * g2 * g2, 0.0)
        c2 = phi - phip * g2
        c = 1.0 + c1 + c2
        # c + s_w/(p1-x) + s_u/(p2-x) = 0 as a quadratic in x
        bq = c * (p1 + p2) + s_w + s_u
        cq = c * p1 * p2 + s_w * p2 + s_u * p1
        disc = bq * bq - 4.0 * c * cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        denom = bq + torch.where(bq >= 0, 1.0, -1.0) * sq
        c_ok = c.abs() > TINY
        r1 = torch.where(c_ok, denom / (2.0 * torch.where(c_ok, c, 1.0)), inf)
        r2 = torch.where(denom.abs() > TINY, 2.0 * cq / denom, inf)
        newton = mu - f / torch.where(fp > 0, fp, 1.0)

        def in_br(x):
            return (x > lo) & (x < hi) & torch.isfinite(x)

        cand = torch.where((disc >= 0) & in_br(r2), r2,
                           torch.where((disc >= 0) & in_br(r1), r1, newton))
        # safeguard: contract toward the violated bound relative to the
        # CURRENT iterate (never global bisection)
        cand = torch.where(torch.isfinite(cand), cand, 0.5 * (lo + hi))
        cand = torch.where(cand <= lo, 0.5 * (mu + lo), cand)
        mu = torch.where(cand >= hi, 0.5 * (mu + hi), cand)
    return shift_d, mu, d1


def _zhat(d, shift_d, mu, rho, active, z_sign, rows: slice = slice(None)):
    """Gu–Eisenstat recomputed ẑ (masked, batched):
    ẑ_j² = (λ_j − d_j)/ρ · ∏_{i≠j} (λ_i − d_j)/(d_i − d_j), active i, j,
    with λ_i − d_j = μ_i − (d_j − σ_i).  ``rows`` restricts it to the
    coordinates j of a panel; each ẑ_j is one product over all roots
    whatever the panel."""
    m = d.shape[1]
    idx = _arange(m, d)
    # [j, i] = λ_i − d_j
    lam_minus_d = mu[:, None, :] - (d[:, rows, None] - shift_d[:, None, :])
    dd_t = d[:, None, :] - d[:, rows, None]         # [j, i] = d_i − d_j
    offdiag = active[:, None, :] & (idx[None, :] != idx[rows, None])
    ratio = lam_minus_d / torch.where(offdiag, dd_t, 1.0)
    prod = torch.where(offdiag, ratio, 1.0).prod(dim=2)
    diag_term = mu[:, rows] - (d[:, rows] - shift_d[:, rows])
    z2h = torch.clamp_min(diag_term * prod / rho[:, None], 0.0)
    return torch.where(active[:, rows], z_sign[:, rows] * torch.sqrt(z2h),
                       0.0)


def _sorted_input(d, z, rho):
    """The merge's input in f64 and in ascending d: (d, z, rho, perm, ds,
    zs, tol), tol the deflation tolerance of each merge."""
    d = d.to(F64)
    z = z.to(F64)
    rho = torch.as_tensor(rho, dtype=F64, device=d.device).reshape(-1)
    eps = torch.finfo(F64).eps
    perm = torch.argsort(d, dim=1, stable=True)
    ds = torch.gather(d, 1, perm)
    zs = torch.gather(z, 1, perm)
    scale = torch.maximum(ds.abs().amax(dim=1),
                          rho * zs.abs().amax(dim=1) ** 2)
    tol = 8.0 * eps * torch.clamp_min(scale, TINY)
    return d, z, rho, perm, ds, zs, tol


def _on_pole(ds, shift_d, mu, zh, active):
    """Numerically-on-pole demotion (see the JAX twin for the story): μ
    below the 1/δ guard, or a dead ẑ at the dominant coordinate (own pole
    when the shift sits there, else the next-active pole) ⇒ the
    eigenvector is the unit vector at that coordinate.  Returns (on_pole,
    dom)."""
    m = ds.shape[1]
    nxt_dom = torch.clamp(_secular_next_active(active), 0, m - 1)
    dom = torch.where(shift_d == ds, _arange(m, ds), nxt_dom)
    on_pole = active & ((mu.abs() <= TINY)
                        | (torch.gather(zh, 1, dom) == 0))
    return on_pole, dom


def _vector_columns(ds, shift_c, mu_c, zh, active, act_c, keep_c, tgt_c):
    """Columns of U, the eigenvectors in rotated-sorted coordinates, of
    the roots λ = σ + μ given by shift_c and mu_c (B, p): ẑ_j/(d_j − λ)
    normalized, and the unit vector at tgt_c where keep_c is false (a
    deflated or on-pole-demoted root).  act_c: the roots' coordinates are
    active."""
    delta = ((ds[:, :, None] - shift_c[:, None, :])
             - mu_c[:, None, :])                    # d_j − λ_i, accurate
    act2 = active[:, :, None] & act_c[:, None, :]
    inv = torch.where(act2 & (delta.abs() > TINY), 1.0 / delta, 0.0)
    zh_col = zh[:, :, None]
    u = torch.where(zh_col != 0, zh_col * inv, 0.0)
    cnorm = torch.sqrt((u * u).sum(dim=1))
    u = u / torch.where(cnorm > 0, cnorm, 1.0)[:, None, :]
    idx = _arange(ds.shape[1], ds)
    eye_cols = (idx[None, :, None] == tgt_c[:, None, :]).to(F64)
    return torch.where(keep_c[:, None, :], u, eye_cols)


def rank1_merge_core(d, z, rho) -> MergeCore:
    """Eigendecompositions of diag(d_b) + ρ_b·z_b·z_bᵀ for a batch of
    merges (ρ ≥ 0, coordinates in any order).  d, z: (B, m); rho: (B,).

    Returns sorted eigenvalues and the orthogonal transforms c so that
    diag(d)+ρzzᵀ = (P G U) diag(λ) (P G U)ᵀ with c = G·U rows in sorted
    coordinates (P = the sort permutation ``perm``).  Close-d runs and
    |ρ·z_j| below tol deflate in place as exact unit columns; roots that
    converge numerically onto a pole are demoted to unit columns too.
    """
    d, z, rho, perm, ds, zs, tol = _sorted_input(d, z, rho)
    bsz, m = d.shape

    zr, u_hat, leaders, tiles = _rotate_runs(ds, zs, tol, m)
    active = (rho[:, None] * zr.abs()) > tol[:, None]
    shift_d, mu, _ = _secular_roots(ds, zr * zr, rho, active)
    z_sign = torch.where(zr >= 0, 1.0, -1.0).to(F64)
    zh = _zhat(ds, shift_d, mu, rho, active, z_sign)

    on_pole, dom = _on_pole(ds, shift_d, mu, zh, active)
    # deflated columns: unit at self; on-pole-demoted: unit at dominant
    tgt = torch.where(on_pole, dom, _arange(m, d))
    u = _vector_columns(ds, shift_d, mu, zh, active, active,
                        active & ~on_pole, tgt)

    lam = torch.where(active, shift_d + mu, ds)
    # undo the run rotation on the left: c = Gᵀ·U = G·U (G symmetric)
    c = apply_run_rotation(u, u_hat, leaders, tiles)

    order = torch.argsort(lam, dim=1, stable=True)
    lam = torch.gather(lam, 1, order)
    c = torch.gather(c, 2, order[:, None, :].expand(bsz, m, m))
    return MergeCore(lam=lam, c=c, perm=perm)


def _panel_width(m: int, panel: int) -> int:
    """The panel, halved until it divides m (the JAX package's rule)."""
    p = min(m, panel)
    while m % p:
        p //= 2
    return p


def rank1_merge_apply_parts(d, z, rho, parts, panel: int = 1024,
                            outs=None):
    """Rank-1 merges of a batch applied to row blocks without building C
    (reference: ``rank1_merge_apply_parts``,
    eigenexa_tpu/ops/secular.py:375).

    d, z: (B, m); rho: (B,).  ``parts``: ((mat, off), ...) with mat
    (B, r, s) of any dtype; part i's product is mat @ C[:, off:off + s]
    with C the (B, m, m) transform in the merges' own coordinates
    (``rank1_merge_core(d, z, rho).unsorted_c()``), cast to mat's dtype.
    ``outs``: None, or per part None or a (B, r, m) tensor (a view will
    do) that takes the product.  Returns (lam (B, m) ascending, tuple of
    the (B, r, m) products).

    Three passes, each a Python loop over panels of p = ``panel`` (halved
    until it divides m): the roots a panel of roots at a time, ẑ a panel
    of coordinates at a time, and C a panel of final columns at a time
    (with the run rotation and the on-pole demotion), each panel
    multiplied into every part's output at once.  Its arithmetic is
    :func:`rank1_merge_core`'s; only the shapes of the sums differ.
    """
    d, z, rho, perm, ds, zs, tol = _sorted_input(d, z, rho)
    bsz, m = d.shape
    p = _panel_width(m, panel)
    zr, u_hat, leaders, tiles = _rotate_runs(ds, zs, tol, p)
    active = (rho[:, None] * zr.abs()) > tol[:, None]
    z2 = zr * zr
    z_sign = torch.where(zr >= 0, 1.0, -1.0).to(F64)
    panels = [slice(k, k + p) for k in range(0, m, p)]

    shift_d, mu = torch.empty_like(ds), torch.empty_like(ds)
    for roots in panels:
        shift_d[:, roots], mu[:, roots], _ = _secular_roots(
            ds, z2, rho, active, roots)
    zh = torch.cat([_zhat(ds, shift_d, mu, rho, active, z_sign, rows)
                    for rows in panels], dim=1)
    on_pole, dom = _on_pole(ds, shift_d, mu, zh, active)
    keep = active & ~on_pole
    tgt = torch.where(on_pole, dom, _arange(m, ds))
    lam = torch.where(active, shift_d + mu, ds)
    order = torch.argsort(lam, dim=1, stable=True)

    inv_perm = torch.argsort(perm, dim=1)
    row_ids = [inv_perm[:, off:off + mat.shape[2], None] for mat, off in parts]
    outs = [torch.empty((bsz, mat.shape[1], m), dtype=mat.dtype,
                        device=mat.device) if out is None else out
            for (mat, _), out in zip(parts, outs or [None] * len(parts))]
    for cols in panels:
        pick = functools.partial(torch.gather, dim=1, index=order[:, cols])
        u = _vector_columns(ds, pick(shift_d), pick(mu), zh, active,
                            pick(active), pick(keep), pick(tgt))
        u = apply_run_rotation(u, u_hat, leaders, tiles)
        for (mat, _), ids, out in zip(parts, row_ids, outs):
            c_rows = torch.gather(u, 1, ids.expand(-1, -1, p))
            out[:, :, cols] = mat @ c_rows.to(mat.dtype)
        del u
    return torch.gather(lam, 1, order), tuple(outs)


def rank1_merge_apply(d, z, rho, q_rows, aux_rows, row_off: int,
                      panel: int = 1024):
    """:func:`rank1_merge_apply_parts` with two parts that share one row
    offset (reference: ``rank1_merge_apply``,
    eigenexa_tpu/ops/secular.py:348): returns (lam, q_rows @ C[:, off:off
    + s], aux_rows @ C[:, off:off + s]), s = q_rows.shape[2]."""
    lam, (q_new, aux_new) = rank1_merge_apply_parts(
        d, z, rho, ((q_rows, row_off), (aux_rows, row_off)), panel=panel)
    return lam, q_new, aux_new
