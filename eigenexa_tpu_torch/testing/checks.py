"""Numerical acceptance checks with the reference's exact constants
(counterpart of ``eigenexa_tpu/testing/checks.py``; reference:
benchmark/ev_test.f:182-204, benchmark/w_test.f:141-175):

  residual      ‖AZ−ZW‖_F / (N·ε·‖A‖_F)   PASS < 768, hard FAIL > 1024
  orthogonality ‖ZᵀZ−I‖_F / (N·ε)         PASS < 8,   hard FAIL > 32
  eigenvalues   max rel & abs error        PASS < √ε,  CAUTION < ε^{1/4}

and for the generalized problem (benchmark/KMATH_EIGEN_GEV_check.f), with
the same constants:

  gev_residual    ‖AZ−BZW‖_F / (N·ε·‖A‖_F)   PASS < 768, hard FAIL > 1024
  b_orthogonality ‖ZᴴBZ−I‖_F / (N·ε)         PASS < 8,   hard FAIL > 32

ε is the dtype's.  The products run in the dtype of the operands at full
precision (``runtime.apply_precision`` keeps TF32 off).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class CheckResult:
    name: str
    value: float
    passed: bool
    hard_fail: bool
    caution: bool = False

    def __bool__(self):
        return self.passed

    def status(self) -> str:
        if self.passed:
            return "PASSED"
        if self.caution:
            return "CAUTION"
        return "FAILED" + (" (hard)" if self.hard_fail else "")

    def __repr__(self):
        return f"<{self.name}: {self.value:.4g} {self.status()}>"


def _blocks(m: int, col_chunk: int):
    """Column blocks [c0, c0 + col_chunk) of m columns; one block when
    col_chunk is 0."""
    step = col_chunk if col_chunk > 0 else max(m, 1)
    return [slice(c0, c0 + step) for c0 in range(0, m, step)]


def residual_check(a, z, w, nvec: Optional[int] = None,
                   col_chunk: int = 0) -> CheckResult:
    """‖AZ−ZW‖_F / (N·ε·‖A‖_F) with PASS<768 / FAIL>1024.

    ``col_chunk`` > 0 streams Z in blocks of that many columns and adds the
    blocks' norms in quadrature, so no n×n product is held beside A and Z
    (reference: checks.py:46)."""
    n = a.shape[0]
    if nvec is not None:
        z = z[:, :nvec]
        w = w[:nvec]
    eps = torch.finfo(a.dtype).eps
    num2 = 0.0
    for cols in _blocks(z.shape[1], col_chunk):
        zc = z[:, cols]
        num2 += float(torch.linalg.norm(
            a @ zc - zc * w[None, cols].to(z.dtype))) ** 2
    val = num2 ** 0.5 / (n * eps * float(torch.linalg.norm(a)))
    return CheckResult("residual", val, val < 768.0, val > 1024.0)


def orthogonality_check(z, nvec: Optional[int] = None,
                        col_chunk: int = 0) -> CheckResult:
    """‖ZᵀZ−I‖_F / (N·ε) with PASS<8 / FAIL>32.

    ``col_chunk`` > 0 takes the Gram matrix in column blocks, each block
    subtracting its part of the identity in place (reference:
    checks.py:80)."""
    n = z.shape[0]
    if nvec is not None:
        z = z[:, :nvec]
    eps = torch.finfo(z.dtype).eps
    val2 = 0.0
    for cols in _blocks(z.shape[1], col_chunk):
        g = z.conj().T @ z[:, cols]
        g[cols].diagonal().sub_(1.0)
        val2 += float(torch.linalg.norm(g)) ** 2
    val = val2 ** 0.5 / (n * eps)
    return CheckResult("orthogonality", val, val < 8.0, val > 32.0)


def eigenvalue_check(w, w_true) -> CheckResult:
    """max relative & absolute eigenvalue error vs a known spectrum, both
    sorted; PASS < √ε, CAUTION < ε^{1/4} (ε of w's dtype)."""
    w = torch.sort(torch.as_tensor(w)).values
    w_true = torch.sort(torch.as_tensor(w_true).to(w.device, w.dtype)).values
    eps = torch.finfo(w.dtype).eps
    eps2, eps4 = eps ** 0.5, eps ** 0.25
    abs_err = (w - w_true).abs()
    denom = w_true.abs()
    rel_err = torch.where(denom > eps, abs_err / torch.clamp_min(denom, eps),
                          0.0)
    val = float(torch.maximum(abs_err.max(), rel_err.max()))
    return CheckResult("eigenvalues", val, val < eps2, val >= eps4,
                       caution=val < eps4)


def eigenvalue_check_scaled(w, w_true, caution_factor: float = 768.0
                            ) -> CheckResult:
    """Backward-stability-scaled eigenvalue check: max|w − w*| / (ε·‖A‖₂)
    with ‖A‖₂ = max|w*|, PASS < 768, hard FAIL > 1024 — the f32 criterion,
    where ε_f32·‖A‖₂ alone exceeds the strict √ε bar.  ε is that of w's
    dtype: pass w in the solve dtype (the port's D&C returns f64 values
    for an f32 solve)."""
    eps = torch.finfo(torch.as_tensor(w).dtype).eps
    w_s = np.sort(np.asarray(torch.as_tensor(w).cpu(), dtype=np.float64))
    w_true_s = np.sort(np.asarray(torch.as_tensor(w_true).cpu(),
                                  dtype=np.float64))
    anorm = float(np.max(np.abs(w_true_s)))
    abs_err = float(np.max(np.abs(w_s - w_true_s)))
    val = abs_err / (eps * max(anorm, 1e-300))
    return CheckResult("eigenvalues_scaled", val, val < caution_factor,
                       val > 1024.0)


def gev_residual_check(a, b, z, w, nvec: Optional[int] = None
                       ) -> CheckResult:
    """‖AZ−BZW‖_F / (N·ε·‖A‖_F), the generalized-problem residual, with
    PASS<768 / FAIL>1024."""
    n = a.shape[0]
    if nvec is not None:
        z = z[:, :nvec]
        w = w[:nvec]
    eps = torch.finfo(a.dtype).eps
    r = a @ z - (b @ z) * w[None, :].to(z.dtype)
    val = float(torch.linalg.norm(r) / (n * eps * torch.linalg.norm(a)))
    return CheckResult("gev_residual", val, val < 768.0, val > 1024.0)


def b_orthogonality_check(z, b, nvec: Optional[int] = None) -> CheckResult:
    """‖ZᴴBZ−I‖_F / (N·ε), the B-orthonormality of generalized
    eigenvectors, with PASS<8 / FAIL>32."""
    n = z.shape[0]
    if nvec is not None:
        z = z[:, :nvec]
    eps = torch.finfo(z.dtype).eps
    g = z.conj().T @ (b @ z)
    g.diagonal().sub_(1.0)
    val = float(torch.linalg.norm(g) / (n * eps))
    return CheckResult("b_orthogonality", val, val < 8.0, val > 32.0)
