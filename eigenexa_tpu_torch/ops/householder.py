"""Blocked Householder tridiagonalization and compact-WY helpers (real
symmetric).

Counterpart of ``eigenexa_tpu/ops/householder.py`` (rolled path only).
The reference's panel loop (src/eigen_trd.F:349) becomes a Python loop over
panels on ONE working matrix: each panel factors ``nb`` columns of the live
trailing block (a strided view), then the rank-2nb trailing update runs in
place on the view ``A[k+nb:, k+nb:]`` through the hand-written
``sub_matmul`` kernel (``ops/kernels.rank2k_update``).  The JAX package's
scan bucketing and up-left roll exist only for XLA compile size and are
not ported; the windowed reduction waits for ROADMAP A11.

The panel recurrence reads the trailing block as it stood at panel start
and corrects each column with the in-panel U and W; the in-place update
therefore runs strictly after the panel's last column (one stream, so call
order is enough).

Real symmetric input only: the Hermitian path is ROADMAP A13.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenexa_tpu_torch.ops.kernels import rank2k_update, wy_apply


class TridiagResult(NamedTuple):
    d: torch.Tensor     # (n,)  diagonal of T
    e: torch.Tensor     # (n-1,) sub-diagonal of T
    v: torch.Tensor     # (n, n) Householder vectors; column k holds the
                        #        reflector zeroing A[k+2:, k] (rows <= k are
                        #        0, row k+1 is 1)
    tau: torch.Tensor   # (n,) reflector scales (tau[k]=0 -> identity)


def householder_vector(x: torch.Tensor, p: int):
    """dlarfg analogue: the reflector (v, tau, beta) that maps x[p:] onto
    beta·e_p, annihilating x[p+1:] below the pivot alpha = x[p].

    The JAX function takes the mask ``idx > j``; here the pivot is the
    Python int p = j + 1, so the tail is a slice instead of a mask.  Returns
    v (v[p] = 1, zero above p), tau (0 when there is nothing to do) and
    beta, the resulting sub-diagonal value.  The tail is pre-scaled by its
    max-abs before the norm (dlarfg's rescaling), so ‖x‖² cannot overflow
    or underflow in f32.
    """
    m = x.shape[0]
    v = torch.zeros_like(x)
    zero = x.new_zeros(())
    if p >= m:
        return v, zero, zero
    alpha = x[p]
    tail = x[p + 1:]
    tiny = torch.finfo(x.dtype).tiny
    if tail.numel():
        scale = torch.clamp_min(tail.abs().amax(), tiny)
        xnorm = torch.linalg.vector_norm(tail / scale) * scale
    else:
        xnorm = zero
    mag = torch.sqrt(alpha * alpha + xnorm * xnorm)
    beta = torch.where(alpha >= 0, -mag, mag)
    active = xnorm > 0
    one = torch.ones_like(beta)
    safe_beta = torch.where(active, beta, one)
    tau = torch.where(active, (safe_beta - alpha) / safe_beta, zero)
    denom = torch.where(active, alpha - safe_beta, one)
    v[p + 1:] = tail / denom
    v[p] = active.to(x.dtype)
    return v, tau, torch.where(active, beta, alpha)


def _panel_body(j: int, b, u_p, w_p, tau_p, e_p):
    """One column of the [dz]latrd-style panel recurrence, in place on the
    panel buffers.  b is the (frozen) trailing block at panel start."""
    # the column as updated by the previous in-panel rank-2 updates:
    # A_cur[:, j] = B[:, j] − U·W[j] − W·U[j]
    col = b[:, j] - u_p @ w_p[j] - w_p @ u_p[j]
    v, tau, beta = householder_vector(col, j + 1)
    # q = A_cur·v (reference: eigen_trd_au, src/eigen_trd_t2.F:161)
    q = b @ v - u_p @ (w_p.T @ v) - w_p @ (u_p.T @ v)
    # w = tau·q − (tau²/2)·(vᵀq)·v so that H·A·H = A − v·wᵀ − w·vᵀ
    # (reference: eigen_trd_compute_v, src/eigen_trd_t6_3.F:85)
    w = tau * q - (tau * tau * 0.5) * torch.dot(v, q) * v
    u_p[:, j] = v
    w_p[:, j] = w
    tau_p[j] = tau
    e_p[j] = beta


def tridiag_panel(b: torch.Tensor, nb: int):
    """Factor ``nb`` columns of the trailing matrix ``b`` (m×m).

    Returns (u_panel, w_panel, tau, e): after this the trailing update is
    b[nb:, nb:] -= U[nb:]·W[nb:]ᵀ + W[nb:]·U[nb:]ᵀ.
    """
    m = b.shape[0]
    u_p = b.new_zeros((m, nb))
    w_p = b.new_zeros((m, nb))
    tau_p = b.new_zeros((nb,))
    e_p = b.new_zeros((nb,))
    for j in range(nb):
        _panel_body(j, b, u_p, w_p, tau_p, e_p)
    return u_p, w_p, tau_p, e_p


def _panel_diag(b, u_p, w_p, nb: int):
    """Diagonal of the updated panel columns:
    d_j = B[j,j] − 2·Σ_l U[j,l]·W[j,l]."""
    return b.diagonal()[:nb] - 2.0 * (u_p[:nb] * w_p[:nb]).sum(dim=1)


def tridiagonalize(a: torch.Tensor, nb: int = 64,
                   donate: bool = False) -> TridiagResult:
    """Reduce symmetric A (n×n) to tridiagonal T = Qᵀ·A·Q.

    Q = H_0·H_1·…·H_{n-3}; reflector k is stored in column k of the
    returned v.  Reference: src/eigen_trd.F:82.  With ``donate=True``
    ``a`` is the working matrix and is destroyed (the solver passes its
    scaled temporary); otherwise it is copied first.
    """
    if a.is_complex():
        raise NotImplementedError("tridiagonalize: Hermitian input is "
                                  "ROADMAP A13")
    work = a if donate else a.clone()
    n = work.shape[0]
    d = work.new_zeros((n,))
    e = work.new_zeros((max(n - 1, 1),))
    v_full = work.new_zeros((n, n))
    tau_full = work.new_zeros((n,))

    k = 0
    while n - k > nb:
        b = work[k:, k:]
        u_p, w_p, tau_p, e_p = tridiag_panel(b, nb)
        d[k:k + nb] = _panel_diag(b, u_p, w_p, nb)
        # rank-2nb trailing update, in place on the live block
        # (reference: eigen_common_2update, src/eigen_t1.F:68)
        trail = b[nb:, nb:]
        rank2k_update(trail, u_p[nb:], w_p[nb:], out=trail)
        e[k:k + nb] = e_p
        v_full[k:, k:k + nb] = u_p
        tau_full[k:k + nb] = tau_p
        k += nb

    # remainder block (m <= nb): factor its columns; no trailing update
    m = n - k
    if m > 1:
        b = work[k:, k:]
        u_p, w_p, tau_p, e_p = tridiag_panel(b, m)
        d[k:] = _panel_diag(b, u_p, w_p, m)
        e[k:k + m - 1] = e_p[:m - 1]
        v_full[k:, k:] = u_p
        tau_full[k:] = tau_p
    elif m == 1:
        d[k] = work[k, k]
    return TridiagResult(d=d, e=e[:n - 1], v=v_full, tau=tau_full)


# ---------------------------------------------------------------------------
# compact WY: T factor and blocked application (back-transform building block)
# ---------------------------------------------------------------------------

def wy_t_factor(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Upper-triangular T with H_0·…·H_{b-1} = I − V·T·Vᵀ (dlarft analogue,
    reference: src/trbakwy4_body.F), from the closed form
    T⁻¹ = diag(1/τ) + strict_upper(VᵀV) and one triangular solve."""
    return wy_t_from_gram(v.T @ v, tau)


def wy_t_from_gram(g: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """`wy_t_factor` from a precomputed Gram matrix G = VᵀV.  Columns with
    τ = 0 have v = 0 and drop out (their diagonal entry is 1)."""
    nb = tau.shape[0]
    nz = tau != 0
    inv_tau = torch.where(nz, 1.0 / torch.where(nz, tau, 1.0), 1.0)
    t_inv = torch.triu(g, diagonal=1) + torch.diag(inv_tau)
    eye = torch.eye(nb, dtype=g.dtype, device=g.device)
    return torch.linalg.solve_triangular(t_inv, eye, upper=True)


def apply_wy_left(z: torch.Tensor, v: torch.Tensor, t: torch.Tensor):
    """Z ← (I − V·T·Vᵀ)·Z in place — one WY block of the back-transform
    (reference: src/trbakwy4_body.F:573-625,721).  The large second
    product streams through the fused subtract-matmul kernel."""
    return wy_apply(z, v, t, out=z)
