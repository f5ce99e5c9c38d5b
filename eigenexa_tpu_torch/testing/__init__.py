"""Verification layer: test-matrix generators and the reference's
numerical acceptance checks (counterpart of ``eigenexa_tpu/testing``)."""

from eigenexa_tpu_torch.testing.checks import (
    CheckResult,
    b_orthogonality_check,
    eigenvalue_check,
    eigenvalue_check_scaled,
    gev_residual_check,
    orthogonality_check,
    residual_check,
)
from eigenexa_tpu_torch.testing.matgen import (
    MATRIX_TYPES,
    designed,
    frank,
    frank2,
    frank_hermitian,
    frank_spectrum,
    helmert_matrix,
    load_matrix_market,
    mat_set,
    random_symmetric,
    toeplitz,
    w_set,
)

__all__ = [
    "MATRIX_TYPES",
    "CheckResult",
    "b_orthogonality_check",
    "designed",
    "eigenvalue_check",
    "eigenvalue_check_scaled",
    "frank",
    "frank2",
    "frank_hermitian",
    "frank_spectrum",
    "gev_residual_check",
    "helmert_matrix",
    "load_matrix_market",
    "mat_set",
    "orthogonality_check",
    "random_symmetric",
    "residual_check",
    "toeplitz",
    "w_set",
]
