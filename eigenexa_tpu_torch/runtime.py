"""Runtime context — the public facade's environment object.

Counterpart of ``eigenexa_tpu/runtime.py`` (reference: eigen_init /
eigen_free / eigen_get_version, src/eigen_libs.F:70-218).  Single device:
the context holds a ``torch.device`` where the JAX package holds a mesh
(the mesh fields wait for ROADMAP A17).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver tunables (reference defaults m_forward=48, m_backward=128,
    src/eigen_libs0.F:49-51).  The JAX config's other fields (``nb_dc``,
    ``band``, ``dc_min_leaf``, ``use_pallas``) are read by no solver code
    and have no counterpart; a CUDA tensor always takes the kernel."""

    panel_forward: int = 64      # TRD panel width (m_forward analogue)
    panel_backward: int = 128    # trbak WY block (m_backward analogue)
    matmul_precision: str = "highest"  # full-f32 products: no TF32


def apply_precision(config: SolverConfig) -> None:
    """Pin float32 products to full precision.  TF32 is the card's
    analogue of the TPU's bf16 default pass, which the JAX package pins
    away (runtime.py:43); orthogonality needs true f32 accumulation."""
    full = config.matmul_precision == "highest"
    torch.backends.cuda.matmul.allow_tf32 = not full
    torch.backends.cudnn.allow_tf32 = not full
    torch.set_float32_matmul_precision(config.matmul_precision)


@dataclasses.dataclass
class EigenContext:
    """The solver environment: device + config.  Returned by
    :func:`eigen_init`; `eigen_free` is a no-op kept for API parity."""

    device: torch.device
    config: SolverConfig = dataclasses.field(default_factory=SolverConfig)


_DEFAULT_CTX: Optional[EigenContext] = None


def eigen_init(device: Union[str, torch.device, None] = None,
               config: Optional[SolverConfig] = None) -> EigenContext:
    """Build the solver environment (reference: eigen_init,
    src/eigen_libs.F:70).  The device defaults to the first CUDA card when
    there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    ctx = EigenContext(device=torch.device(device),
                       config=config or SolverConfig())
    apply_precision(ctx.config)
    global _DEFAULT_CTX
    _DEFAULT_CTX = ctx
    return ctx


def default_context() -> EigenContext:
    if _DEFAULT_CTX is None:
        return eigen_init()
    return _DEFAULT_CTX


def eigen_free(ctx: Optional[EigenContext] = None) -> None:
    """API-parity no-op (reference: eigen_free, src/eigen_libs.F:204)."""
    global _DEFAULT_CTX
    if ctx is None or ctx is _DEFAULT_CTX:
        _DEFAULT_CTX = None


def eigen_get_version():
    """(version, date, codename) — reference: eigen_get_version
    (src/eigen_libs0.F:29-48)."""
    from eigenexa_tpu_torch import __codename__, __version__

    return __version__, "2026-10-16", __codename__


def eigen_show_version(printer=print):
    v, date, name = eigen_get_version()
    printer(f"eigenexa_tpu_torch version {v} ({date}) '{name}' — "
            f"PyTorch/CUDA eigensolver")
