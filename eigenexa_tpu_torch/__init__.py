"""eigenexa_tpu_torch — the PyTorch/CUDA port of eigenexa_tpu.

Single-device ``eigen_s`` (real symmetric, modes A/S/T/C): blocked
Householder tridiagonalization, batched divide & conquer, WY
back-transform.  The JAX package ``eigenexa_tpu`` stays beside it as the
reference the port is held to; this package imports torch and never jax.

The Pallas TPU kernel on this path, the fused subtract-matmul, is a
hand-written CUDA kernel for Hopper (``csrc/sub_matmul.cu``), built with
nvcc at first use.  A CPU tensor takes each kernel's plain PyTorch version;
a CUDA tensor launches the kernel or raises.
"""

from eigenexa_tpu_torch.runtime import (
    EigenContext,
    SolverConfig,
    eigen_free,
    eigen_get_version,
    eigen_init,
    eigen_show_version,
)
from eigenexa_tpu_torch.solvers.solver import SolveInfo, eigen_s, eigh

__version__ = "0.1.0"
__codename__ = "takanoha"

__all__ = [
    "EigenContext",
    "SolveInfo",
    "SolverConfig",
    "eigen_free",
    "eigen_get_version",
    "eigen_init",
    "eigen_s",
    "eigen_show_version",
    "eigh",
]
