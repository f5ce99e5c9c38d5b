"""Runtime context — the public facade's environment object.

Counterpart of ``eigenexa_tpu/runtime.py`` (reference: eigen_init /
eigen_free / eigen_get_procs / eigen_get_id / eigen_get_matdims /
eigen_get_version, src/eigen_libs.F:70-218, src/eigen_libs0.F:1575-1689).
The context holds this process's ``torch.device`` and, for the distributed
drivers, an optional mesh (``parallel.mesh.Mesh``: this rank's place on the
px × py grid and its process groups).  Without a mesh the process is a
1×1 grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from eigenexa_tpu_torch.parallel import layout


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
    """The solver environment: device + config, and the mesh of a
    distributed run.  Returned by :func:`eigen_init`; `eigen_free` is a
    no-op kept for API parity."""

    device: torch.device
    config: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    mesh: Optional[object] = None

    @property
    def grid(self) -> Tuple[int, int]:
        return (1, 1) if self.mesh is None else self.mesh.shape

    @property
    def nnod(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def x_nnod(self) -> int:
        return self.grid[0]

    @property
    def y_nnod(self) -> int:
        return self.grid[1]

    def matdims(self, n: int) -> Tuple[int, int]:
        """Padded per-process dims of an n×n matrix (eigen_get_matdims,
        src/eigen_libs.F:106)."""
        lr, lc = layout.padded_local_dims(n, *self.grid)
        layout.check_int32_overflow(n, lr, lc)
        return lr, lc


_DEFAULT_CTX: Optional[EigenContext] = None


def eigen_init(device: Union[str, torch.device, None] = None,
               config: Optional[SolverConfig] = None,
               mesh=None) -> EigenContext:
    """Build the solver environment (reference: eigen_init,
    src/eigen_libs.F:70).  The device defaults to the mesh's, else to the
    current CUDA card, whether or not one is present, so a solve never
    moves to the CPU unasked; a caller asks for the CPU with
    ``eigen_init("cpu")``.  Building the context needs no card: the first
    solve that moves an input to the card does.  `mesh` (from
    ``parallel.mesh.build_mesh``) stands in for the reference's
    communicator."""
    if device is None and mesh is not None:
        device = mesh.device
    ctx = EigenContext(device=torch.device(device or "cuda"),
                       config=config or SolverConfig(), mesh=mesh)
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


def eigen_get_procs(ctx: Optional[EigenContext] = None):
    """(nnod, x_nnod, y_nnod) (reference: src/eigen_libs0.F:1575)."""
    ctx = ctx or default_context()
    return ctx.nnod, ctx.x_nnod, ctx.y_nnod


def eigen_get_id(ctx: Optional[EigenContext] = None):
    """(inod, x_inod, y_inod) of this process, 0-based: its index on the
    mesh and its grid position (reference: src/eigen_libs0.F:1615).  Each
    rank is a process of its own, so this is the caller's own rank, where
    the JAX package's one controller process could only report itself."""
    ctx = ctx or default_context()
    if ctx.mesh is None:
        return 0, 0, 0
    return ctx.mesh.index, ctx.mesh.ix, ctx.mesh.iy


def eigen_get_matdims(n: int, ctx: Optional[EigenContext] = None):
    """Padded per-process (rows, cols) of an n×n matrix."""
    ctx = ctx or default_context()
    return ctx.matdims(n)


def eigen_get_version():
    """(version, date, codename) — reference: eigen_get_version
    (src/eigen_libs0.F:29-48)."""
    from eigenexa_tpu_torch import __codename__, __version__

    return __version__, "2026-10-16", __codename__


def eigen_show_version(printer=print):
    v, date, name = eigen_get_version()
    printer(f"eigenexa_tpu_torch version {v} ({date}) '{name}' — "
            f"PyTorch/CUDA eigensolver")
