"""A plain band-2 (pentadiagonal) reference, in torch alone: the reduction
one reflector a column, and the pentadiagonal's eigenpairs from
``torch.linalg.eigh`` on the dense P.

It imports nothing of the port, no kernel and no JAX, so it runs wherever
torch does, the card's machine included, and checks the port's PRD-BLK
stage (``ops/band.band2_reduce``) and band-2 D&C
(``solvers/dc_band.solve_band2_dc``) without the JAX package.

The reduction, float64: for k = 0 … n−3 one Householder reflector H_k,
pivot row k+2, zeroes column k below row k+2, and is applied two-sided to
the whole trailing block A[k+1:, k+1:] (H_k acts as the identity on row
and column k+1):

    w = τ·S·v − (τ²/2)·(vᵀ·S·v)·v,    S ← S − v·wᵀ − w·vᵀ.

Column k+1 of H_k·A·H_k is then H_k·a_{k+1}, which is what the port's
``pair_reflectors`` forms analytically, so in exact arithmetic both give
the same (d, e1, e2), signs included.  Departures from the reference's
PRD-BLK (src/eigen_prd.F:80) and from the port:

* one reflector a step, not a pair of columns a step: no CholeskyQR2 of
  the pair (eigen_prd_t4x.F:140-283), no analytic H₀ fix-up
  (eigen_prd_t4x.F:305), no 2×2 coupling matrix T (eigen_prd.F:363);
* no panels: every reflector updates the whole trailing block at once,
  so there is no deferred rank-2nb update, no U·Wᵀ correction of a
  column and no workspace; the matvec reads the updated block itself;
* the full square is updated, not one triangle, and the reflectors are
  not kept (the bands alone are compared);
* the reflector is LAPACK's dlarfg with β = −sign(α)·‖x‖ and an unscaled
  norm, as the port's ``householder_vector`` on matrices far from
  overflow.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _exact_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def band2_reduce(a: torch.Tensor):
    """(d, e1, e2) of the pentadiagonal P = Qᵀ·A·Q of the symmetric ``a``,
    unblocked, in float64 on ``a``'s device.  ``a`` is not changed."""
    _exact_products()
    a = a.to(F64).clone()
    n = a.shape[0]
    for k in range(n - 2):
        x = a[k + 2:, k]
        alpha, tail = x[0], x[1:]
        xnorm = torch.linalg.vector_norm(tail)
        active = xnorm > 0
        mag = torch.sqrt(alpha * alpha + xnorm * xnorm)
        beta = torch.where(alpha >= 0, -mag, mag)
        safe = torch.where(active, beta, torch.ones_like(beta))
        tau = torch.where(active, (safe - alpha) / safe,
                          torch.zeros_like(beta))
        # v over rows k+1 …: 0 on row k+1, 1 on the pivot, the tail scaled
        v = torch.zeros(n - k - 1, dtype=F64, device=a.device)
        v[1] = 1.0
        v[2:] = tail / torch.where(active, alpha - safe,
                                   torch.ones_like(beta))
        s = a[k + 1:, k + 1:]
        p = tau * (s @ v)
        w = p - (0.5 * tau * torch.dot(v, p)) * v
        s.addr_(v, w, alpha=-1).addr_(w, v, alpha=-1)
        pivot = torch.where(active, beta, alpha)
        a[k + 2, k] = pivot
        a[k, k + 2] = pivot
        a[k + 3:, k] = 0
        a[k, k + 3:] = 0
    return (a.diagonal().clone(), a.diagonal(-1).clone(),
            a.diagonal(-2).clone())


def assemble(d, e1, e2) -> torch.Tensor:
    """The dense symmetric pentadiagonal of (d, e1, e2), float64."""
    p = torch.diag(d.to(F64))
    if d.shape[0] > 1:
        e1 = e1.to(F64)
        p = p + torch.diag(e1, 1) + torch.diag(e1, -1)
    if d.shape[0] > 2:
        e2 = e2.to(F64)
        p = p + torch.diag(e2, 2) + torch.diag(e2, -2)
    return p


def band2_eigh(d, e1, e2):
    """Ascending eigenvalues and orthonormal eigenvectors (columns) of the
    pentadiagonal (d, e1, e2): ``torch.linalg.eigh`` on the dense P, float64
    (the reference for ``solve_band2_dc``)."""
    _exact_products()
    return torch.linalg.eigh(assemble(d, e1, e2))


def band2_eigvalsh(d, e1, e2) -> torch.Tensor:
    """Ascending eigenvalues of the pentadiagonal (d, e1, e2), float64."""
    _exact_products()
    return torch.linalg.eigvalsh(assemble(d, e1, e2))
