"""Verification layer: test-matrix generators and the reference's
numerical acceptance checks (counterpart of ``eigenexa_tpu/testing``)."""

from eigenexa_tpu_torch.testing.checks import (
    CheckResult,
    eigenvalue_check,
    eigenvalue_check_scaled,
    orthogonality_check,
    residual_check,
)
from eigenexa_tpu_torch.testing.matgen import (
    frank,
    frank_spectrum,
    mat_set,
    random_symmetric,
)

__all__ = [
    "CheckResult",
    "eigenvalue_check",
    "eigenvalue_check_scaled",
    "frank",
    "frank_spectrum",
    "mat_set",
    "orthogonality_check",
    "random_symmetric",
    "residual_check",
]
