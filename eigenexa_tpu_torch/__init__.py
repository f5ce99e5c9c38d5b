"""eigenexa_tpu_torch — the PyTorch/CUDA port of eigenexa_tpu.

Single-device drivers:

* ``eigen_s`` (real symmetric, modes A/N/X/S/T/C/R): blocked Householder
  tridiagonalization, batched divide & conquer, WY back-transform;
* ``eigen_sx``, the band-2 path: a one-stage reduction to pentadiagonal
  form by two-column reflector pairs (``ops/band.py``), a banded divide &
  conquer with two rank-1 merges a join (``solvers/dc_band.py``), the same
  back-transform;
* ``eigen_h`` (complex Hermitian, modes A/N/X/T/S/C): the complex rolled
  reduction to a real tridiagonal, the real D&C, the complex back-transform
  (``solvers/hermitian.py``);
* ``eigen_gev`` (generalized symmetric-definite, modes A and N): the
  spectral reduction over two ``eigen_s`` solves (``solvers/gev.py``).

Modes N and X of ``eigen_s`` and ``eigen_sx`` bisect with Sturm counts
(``ops/sturm.py``); mode R runs the D&C alone on saved stage data
(``utils/stageio.py``).  The JAX package ``eigenexa_tpu`` stays beside it as
the reference the port is held to; this package imports torch and never
jax.

Each real reduction comes rolled (the default) or windowed (one n×n
buffer); the Hermitian one is rolled.
The three Pallas TPU kernels of the JAX package are hand-written CUDA
kernels for Hopper, built with nvcc at first use: ``sub_matmul`` (B − P·Qᴴ,
real and complex: the rolled reductions' trailing updates and every
back-transform block) and
``rank2k_update_window`` (the windowed reductions' trailing updates), both
in ``csrc/sub_matmul.cu``; ``symv_lower`` (the windowed reductions'
lower-triangle matvec: one vector with the panel's corrections for a
column, two for a band-2 pair; ``csrc/symv_lower.cu``).  A fourth kernel,
``sturm_bisect`` (``csrc/sturm.cu``), is the card form of the JAX package's
``lax.scan`` Sturm recurrence, by multisection: a group of lanes an
eigenvalue index, several bisection steps a round.  A CPU
tensor takes each kernel's plain PyTorch version; a CUDA tensor launches
the kernel or raises.
"""

from eigenexa_tpu_torch.runtime import (
    EigenContext,
    SolverConfig,
    eigen_free,
    eigen_get_version,
    eigen_init,
    eigen_show_version,
)
from eigenexa_tpu_torch.solvers.gev import eigen_gev
from eigenexa_tpu_torch.solvers.hermitian import eigen_h
from eigenexa_tpu_torch.solvers.solver import (SolveInfo, eigen_s,
                                               eigen_sx, eigh)

__version__ = "0.1.0"
__codename__ = "takanoha"

__all__ = [
    "EigenContext",
    "SolveInfo",
    "SolverConfig",
    "eigen_free",
    "eigen_get_version",
    "eigen_gev",
    "eigen_h",
    "eigen_init",
    "eigen_s",
    "eigen_sx",
    "eigen_show_version",
    "eigh",
]
