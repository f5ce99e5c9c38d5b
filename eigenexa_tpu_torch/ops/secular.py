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
over the (m, m) same-run mask, and the run rotation one batched GEMM —
no ``index_add_``/``scatter_add_``, whose float atomics on CUDA would sum
in a different order from run to run.  The runs are contiguous (the
leaders are non-decreasing), so the mask is block diagonal.
"""

from __future__ import annotations

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


def _same_run(leaders: torch.Tensor) -> torch.Tensor:
    """(B, m, m) mask: coordinates i and j belong to the same run."""
    return leaders[:, :, None] == leaders[:, None, :]


def _run_sum(x: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """Per-coordinate sum of x (B, m) over its run (the JAX
    ``segment_sum(x, leaders)[leaders]``), atomic-free."""
    return torch.where(same, x[:, None, :], 0.0).sum(dim=2)


def _rotate_runs(d, z, tol):
    """Per-run Householder rotation concentrating each run's z-weight into
    its leader.  Returns (z_new, u_hat, leaders): the rotation is
    G = I − 2·Σ_r û_r·û_rᵀ with disjoint-support û_r
    (apply with :func:`apply_run_rotation`)."""
    m = d.shape[1]
    leaders = _run_leaders(d, tol)
    same = _same_run(leaders)
    is_leader = _arange(m, d) == leaders
    norm_r = torch.sqrt(_run_sum(z * z, same))      # per-coordinate run ‖z‖
    singleton = same.sum(dim=2) <= 1
    z_lead = torch.gather(z, 1, leaders)
    sgn = torch.where(z_lead >= 0, 1.0, -1.0).to(z.dtype)
    u = z + torch.where(is_leader, sgn * norm_r, 0.0)
    u = torch.where(singleton, 0.0, u)
    # normalize per run with max-abs pre-scaling: a run of uniformly tiny
    # z's must still yield an exactly-unit û, or G is not orthogonal
    u_max = torch.where(same, u.abs()[:, None, :], 0.0).amax(dim=2)
    u_sc = u / torch.where(u_max > 0, u_max, 1.0)
    u_n2 = _run_sum(u_sc * u_sc, same)
    u_hat = u_sc / torch.sqrt(torch.where(u_n2 > 0, u_n2, 1.0))
    z_new = torch.where(singleton, z,
                        torch.where(is_leader, -sgn * norm_r, 0.0))
    return z_new, u_hat, leaders


def apply_run_rotation(mat, u_hat, leaders):
    """M ← G·M with G = I − 2·Σ_r û_r·û_rᵀ (rows of M (B, m, k) are
    coordinates).  One batched GEMM against the block-diagonal matrix
    W[i, j] = û_j·[same run]: fixed summation order, no atomics."""
    w = torch.where(_same_run(leaders), u_hat[:, None, :], 0.0)
    return mat - 2.0 * u_hat[:, :, None] * torch.bmm(w, mat)


def _secular_next_active(active: torch.Tensor) -> torch.Tensor:
    """Per-coordinate index of the next active coordinate (> self); m+1
    when none.  (B, m) bool -> (B, m) int64."""
    bsz, m = active.shape
    tagged = torch.where(active, _arange(m, active), m + 1)
    suf = torch.flip(torch.cummin(torch.flip(tagged, [1]), dim=1).values,
                     [1])
    return torch.cat([suf[:, 1:], torch.full((bsz, 1), m + 1,
                                             device=active.device)], dim=1)


def _secular_roots(d, z2, rho, active):
    """Roots of 1 + ρ·Σ_j z_j²/(d_j − λ) for every merge of the batch, all
    in parallel.  d, z2, active: (B, m); rho: (B,).

    Root i (active) lives in (d_i, next-active d_i').  Returns
    (shift_d σ, mu, d1) with λ_i = σ_i + μ_i and d1[b, j, i] = d_j − σ_i —
    the cancellation-free representation dlaed4 mandates.
    """
    bsz, m = d.shape
    idx = _arange(m, d)
    rho_c = rho[:, None]
    nxt = _secular_next_active(active)
    zA = torch.where(active, z2, 0.0)
    sumz2 = zA.sum(dim=1, keepdim=True)
    # scale-relative slack: λ_max < d_max + ρ‖z‖² strictly
    slack = torch.clamp_min(rho_c * sumz2, TINY)

    a = d
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
    low_mask = idx[:, None] <= idx[None, :]         # j <= i : psi part
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


def _zhat(d, d1, mu, rho, active, z_sign):
    """Gu–Eisenstat recomputed ẑ (masked, batched):
    ẑ_j² = (λ_j − d_j)/ρ · ∏_{i≠j} (λ_i − d_j)/(d_i − d_j), active i, j."""
    m = d.shape[1]
    idx = _arange(m, d)
    lam_minus_d = mu[:, None, :] - d1               # [j, i] = λ_i − d_j
    dd_t = d[:, None, :] - d[:, :, None]            # [j, i] = d_i − d_j
    offdiag = active[:, None, :] & (idx[None, :] != idx[:, None])
    ratio = lam_minus_d / torch.where(offdiag, dd_t, 1.0)
    prod = torch.where(offdiag, ratio, 1.0).prod(dim=2)
    diag_term = lam_minus_d.diagonal(dim1=1, dim2=2)
    z2h = torch.clamp_min(diag_term * prod / rho[:, None], 0.0)
    return torch.where(active, z_sign * torch.sqrt(z2h), 0.0)


def rank1_merge_core(d, z, rho) -> MergeCore:
    """Eigendecompositions of diag(d_b) + ρ_b·z_b·z_bᵀ for a batch of
    merges (ρ ≥ 0, coordinates in any order).  d, z: (B, m); rho: (B,).

    Returns sorted eigenvalues and the orthogonal transforms c so that
    diag(d)+ρzzᵀ = (P G U) diag(λ) (P G U)ᵀ with c = G·U rows in sorted
    coordinates (P = the sort permutation ``perm``).  Close-d runs and
    |ρ·z_j| below tol deflate in place as exact unit columns; roots that
    converge numerically onto a pole are demoted to unit columns too.
    """
    d = d.to(F64)
    z = z.to(F64)
    rho = torch.as_tensor(rho, dtype=F64, device=d.device).reshape(-1)
    bsz, m = d.shape
    eps = torch.finfo(F64).eps

    perm = torch.argsort(d, dim=1, stable=True)
    ds = torch.gather(d, 1, perm)
    zs = torch.gather(z, 1, perm)
    scale = torch.maximum(ds.abs().amax(dim=1),
                          rho * zs.abs().amax(dim=1) ** 2)
    tol = 8.0 * eps * torch.clamp_min(scale, TINY)

    zr, u_hat, leaders = _rotate_runs(ds, zs, tol)
    active = (rho[:, None] * zr.abs()) > tol[:, None]
    shift_d, mu, d1 = _secular_roots(ds, zr * zr, rho, active)
    z_sign = torch.where(zr >= 0, 1.0, -1.0).to(F64)
    zh = _zhat(ds, d1, mu, rho, active, z_sign)

    # ---- numerically-on-pole demotion (see the JAX twin for the story):
    # μ below the 1/δ guard, or a dead ẑ at the dominant coordinate (own
    # pole when the shift sits there, else the next-active pole) ⇒ the
    # eigenvector is the unit vector at that coordinate
    idx = _arange(m, d)
    nxt_dom = torch.clamp(_secular_next_active(active), 0, m - 1)
    dom = torch.where(shift_d == ds, idx, nxt_dom)
    on_pole = active & ((mu.abs() <= TINY)
                        | (torch.gather(zh, 1, dom) == 0))
    act_vec = active & ~on_pole

    # eigenvector matrix U in rotated-sorted coordinates
    delta = d1 - mu[:, None, :]                     # d_j − λ_i, accurate
    act2 = active[:, :, None] & active[:, None, :]
    inv = torch.where(act2 & (delta.abs() > TINY), 1.0 / delta, 0.0)
    zh_col = zh[:, :, None]
    u = torch.where(zh_col != 0, zh_col * inv, 0.0)
    cnorm = torch.sqrt((u * u).sum(dim=1))
    u = u / torch.where(cnorm > 0, cnorm, 1.0)[:, None, :]
    # deflated columns: unit at self; on-pole-demoted: unit at dominant
    tgt = torch.where(on_pole, dom, idx)
    eye_cols = (idx[None, :, None] == tgt[:, None, :]).to(F64)
    u = torch.where(act_vec[:, None, :], u, eye_cols)

    lam = torch.where(active, shift_d + mu, ds)
    # undo the run rotation on the left: c = Gᵀ·U = G·U (G symmetric)
    c = apply_run_rotation(u, u_hat, leaders)

    order = torch.argsort(lam, dim=1, stable=True)
    lam = torch.gather(lam, 1, order)
    c = torch.gather(c, 2, order[:, None, :].expand(bsz, m, m))
    return MergeCore(lam=lam, c=c, perm=perm)
