"""eigenexa_tpu_torch — the PyTorch/CUDA port of eigenexa_tpu.

Single-device ``eigen_s`` (real symmetric, modes A/S/T/C): blocked
Householder tridiagonalization, batched divide & conquer, WY
back-transform.  The JAX package ``eigenexa_tpu`` stays beside it as the
reference the port is held to; this package imports torch and never jax.

Two reductions to tridiagonal form: the rolled one (the default) and the
windowed one, which factors the matrix in one n×n buffer.  The three Pallas
TPU kernels of the JAX package are hand-written CUDA kernels for Hopper,
built with nvcc at first use: ``sub_matmul`` (B − P·Qᵀ: the rolled
reduction's trailing update and every back-transform block) and
``rank2k_update_window`` (the windowed reduction's trailing update), both in
``csrc/sub_matmul.cu``; ``symv_lower`` (the windowed reduction's
lower-triangle matvec with the panel's corrections, ``csrc/symv_lower.cu``).
A CPU tensor takes each kernel's plain PyTorch version; a CUDA tensor
launches the kernel or raises.
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
