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
    designed,
    frank,
    frank_hermitian,
    frank_spectrum,
    helmert_matrix,
    mat_set,
    random_symmetric,
)

__all__ = [
    "CheckResult",
    "b_orthogonality_check",
    "designed",
    "eigenvalue_check",
    "eigenvalue_check_scaled",
    "frank",
    "frank_hermitian",
    "frank_spectrum",
    "gev_residual_check",
    "helmert_matrix",
    "mat_set",
    "orthogonality_check",
    "random_symmetric",
    "residual_check",
]
