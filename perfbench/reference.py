"""The plain reference that decides ``correct``: torch and numpy only.

It never imports the program and takes nothing the program made but the
outputs it judges.  The spectrum comes from ``torch.linalg.eigh`` (or
``eigvalsh`` where no vectors are asked for) on the benchmark's own input,
in float64, the precision the configurations state; the program's
eigenvectors are judged against the input matrix itself, by the
reference's own acceptance numbers (``benchmark/ev_test.f:182-204``):

  w_gap              max|w − w_ref| / (ε·‖A‖₂), ‖A‖₂ = max|w_ref|
  residual           ‖AZ − ZW‖_F / (N·ε·‖A‖_F)
  orthogonality      ‖ZᵀZ − I‖_F / (N·ε)
  residual_sampled   the residual estimated from k columns:
                     √(N/k·Σ_j ‖A·z_j − w_j·z_j‖²) / (N·ε·‖A‖_F)

ε is that of the configuration's dtype, whatever precision the judged
outputs carry; every product runs in float64 with TF32 off.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _exact_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def spectrum(a: torch.Tensor, vectors: bool) -> torch.Tensor:
    """Ascending float64 eigenvalues of the symmetric ``a``: ``eigh``
    when the cell asks for vectors (its incumbent), else ``eigvalsh``."""
    _exact_products()
    a = a.to(F64)
    if vectors:
        return torch.linalg.eigh(a)[0]
    return torch.linalg.eigvalsh(a)


def w_gap(w: torch.Tensor, w_ref: torch.Tensor, eps: float) -> float:
    """Widest gap of the sorted ``w`` to ``w_ref``, in ε·‖A‖₂."""
    w = torch.sort(w.to(F64)).values
    anorm = float(w_ref.abs().amax())
    return float((w - w_ref).abs().amax()) / (eps * max(anorm, 1e-300))


def _col_blocks(m: int, chunk: int):
    return [slice(c, min(c + chunk, m)) for c in range(0, m, chunk)]


def residual(a: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
             eps: float, chunk: int = 1024) -> float:
    """‖AZ − ZW‖_F / (N·ε·‖A‖_F) over Z's columns, in column blocks."""
    _exact_products()
    a = a.to(F64)
    n = a.shape[0]
    num2 = 0.0
    for cols in _col_blocks(z.shape[1], chunk):
        zc = z[:, cols].to(F64)
        num2 += float(torch.linalg.vector_norm(
            a @ zc - zc * w[cols].to(F64)[None, :])) ** 2
    return num2 ** 0.5 / (n * eps * float(torch.linalg.vector_norm(a)))


def orthogonality(z: torch.Tensor, eps: float, chunk: int = 1024) -> float:
    """‖ZᵀZ − I‖_F / (N·ε), the Gram matrix in column blocks."""
    _exact_products()
    n = z.shape[0]
    z64 = z.to(F64)
    val2 = 0.0
    for cols in _col_blocks(z64.shape[1], chunk):
        g = z64.T @ z64[:, cols]
        g[cols].diagonal().sub_(1.0)
        val2 += float(torch.linalg.vector_norm(g)) ** 2
    return val2 ** 0.5 / (n * eps)


def residual_sampled(a: torch.Tensor, zs: torch.Tensor, ws: torch.Tensor,
                     eps: float) -> float:
    """The residual estimated from the k sampled eigenpairs (zs: N×k, ws:
    k): the same scale as :func:`residual` over all N columns."""
    _exact_products()
    a = a.to(F64)
    n, k = zs.shape
    zs = zs.to(F64)
    r = a @ zs - zs * ws.to(F64)[None, :]
    est = (n / k) ** 0.5 * float(torch.linalg.vector_norm(r))
    return est / (n * eps * float(torch.linalg.vector_norm(a)))
