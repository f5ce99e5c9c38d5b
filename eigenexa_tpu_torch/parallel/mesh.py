"""The 2D process grid over a ``torch.distributed`` process group
(counterpart of ``eigenexa_tpu/parallel/mesh.py``; reference: the grid
setup of ``eigen_init0``, src/eigen_libs0.F:477-572).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices driven by one
program; here each grid point is a process (a rank), and the mesh holds the
process groups its collectives run on:

* the 'x' group of a rank: the ranks of its grid column (same iy), which
  shard matrix *rows* (the reference's x_COMM_WORLD);
* the 'y' group: the ranks of its grid row (same ix), which shard matrix
  *columns* (y_COMM_WORLD);
* the grid group: every rank of the mesh (TRD_COMM_WORLD);
* the merge groups of the distributed D&C: contiguous runs of ``gsz`` flat
  ranks (flat = ix·py + iy), for every power of two ``gsz`` that divides P
  (the FS tree's MERGE_GROUPs, src/FS_dividing.F90:22-55).

A group of one rank is not created (``None``): a collective over it is the
identity, and the collectives skip it, as XLA elides a psum over an axis of
size 1.  The grid group is always created, so that a 1×1 mesh still holds a
real communicator (``collectives.calibrate_overheads`` times it).

A mesh may cover a subset of the world's ranks, so one world can host
several mesh shapes.  ``torch.distributed.new_group`` is collective over the
whole world: every rank of the world calls :func:`build_mesh` with the same
arguments, in the same order, and a rank outside the mesh gets ``None``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def factor_grid(p: int) -> Tuple[int, int]:
    """Factor P processes into (x, y) with x the largest divisor of P ≤ √P
    (reference: eigen_init0, src/eigen_libs0.F:477-572).  x ≤ y, x·y = P."""
    if p < 1:
        raise ValueError(f"process count must be >= 1, got {p}")
    x = 1
    for d in range(1, math.isqrt(p) + 1):
        if p % d == 0:
            x = d
    return x, p // x


def grid_positions(p: int, shape: Tuple[int, int], order: str = "C"
                   ) -> List[Tuple[int, int]]:
    """(ix, iy) of the mesh's r-th rank, r = 0 … P−1: column-major ('C',
    the reference's default) places r at (r % px, r // px), row-major ('R')
    at (r // py, r % py) (the ``order`` of eigen_init, src/eigen_libs.F:70;
    JAX ``build_mesh``, mesh.py:69-75)."""
    px, py = shape
    if px * py != p:
        raise ValueError(f"grid shape {shape} does not cover {p} ranks")
    if order.upper() == "C":
        return [(r % px, r // px) for r in range(p)]
    if order.upper() == "R":
        return [(r // py, r % py) for r in range(p)]
    raise ValueError(f"order must be 'C' or 'R', got {order!r}")


class Mesh:
    """One rank's view of the px × py grid: its position, its device and
    its process groups.  Built by :func:`build_mesh`."""

    def __init__(self, shape, ranks, positions, rank, device, backend,
                 groups):
        self.shape: Tuple[int, int] = tuple(shape)
        self.ranks: Tuple[int, ...] = tuple(ranks)   # world ranks, r order
        self.positions = tuple(positions)            # (ix, iy) of each
        self.rank: int = rank                        # world rank of this
        self.device: torch.device = device
        self.backend: str = backend
        self.index = self.ranks.index(rank)          # r: position in ranks
        self.ix, self.iy = self.positions[self.index]
        self.x_group = groups["x"]
        self.y_group = groups["y"]
        self.grid_group = groups["grid"]
        self.merge_groups: Dict[int, object] = groups["merge"]
        # the order in which an all_gather over the grid returns the ranks'
        # pieces: ascending world rank (new_group sorts its ranks)
        self.grid_order = [self.positions[self.ranks.index(w)]
                           for w in sorted(self.ranks)]

    @property
    def px(self) -> int:
        return self.shape[0]

    @property
    def py(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.px * self.py

    @property
    def flat(self) -> int:
        """The D&C tree's rank: ix·py + iy."""
        return self.ix * self.py + self.iy

    def __repr__(self) -> str:
        return (f"Mesh({self.px}x{self.py}, rank {self.rank} at "
                f"({self.ix}, {self.iy}), {self.backend} on {self.device})")


def _group(members: Sequence[int]):
    """A process group of `members` (called by every world rank); None for
    one member."""
    members = sorted(members)
    group = dist.new_group(members)
    return group if len(members) > 1 else None


def build_mesh(shape: Optional[Tuple[int, int]] = None, order: str = "C",
               ranks: Optional[Sequence[int]] = None, device=None
               ) -> Optional[Mesh]:
    """The solver mesh over world ranks `ranks` (default: the whole world),
    of `shape` (default ``factor_grid(len(ranks))``), placed in `order`.
    Every world rank calls it with the same arguments; ranks outside the
    mesh get None.  `device` is this rank's device (default: the current
    card, ``torch.cuda.current_device()``; without a card it raises, and
    the mesh runs on the CPU only when asked, ``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: no CUDA device is visible; pass "
                               "device='cpu' for a mesh on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    ranks = list(range(world) if ranks is None else ranks)
    p = len(ranks)
    shape = tuple(shape) if shape is not None else factor_grid(p)
    positions = grid_positions(p, shape, order)
    px, py = shape
    at = {pos: ranks[r] for r, pos in enumerate(positions)}
    x_groups = {iy: _group([at[(ix, iy)] for ix in range(px)])
                if px > 1 else None for iy in range(py)}
    y_groups = {ix: _group([at[(ix, iy)] for iy in range(py)])
                if py > 1 else None for ix in range(px)}
    grid = dist.new_group(sorted(ranks))
    flat_rank = {ix * py + iy: at[(ix, iy)] for ix in range(px)
                 for iy in range(py)}
    merge = {}
    gsz = 2
    while gsz < p and p % gsz == 0:
        merge[gsz] = {g: _group([flat_rank[f] for f in
                                 range(g * gsz, (g + 1) * gsz)])
                      for g in range(p // gsz)}
        gsz *= 2
    me = dist.get_rank()
    if me not in ranks:
        return None
    ix, iy = positions[ranks.index(me)]
    backend = dist.get_backend()
    flat = ix * py + iy
    groups = {"x": x_groups[iy], "y": y_groups[ix], "grid": grid,
              "merge": {g: m[flat // g] for g, m in merge.items()}}
    return Mesh(shape, ranks, positions, me, torch.device(device), backend,
                groups)


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    """(x_nnod, y_nnod) of a solver mesh."""
    return mesh.shape


def single_device_mesh(device=None) -> Optional[Mesh]:
    """A 1×1 mesh of world rank 0: the P = 1 path (the reference's serial
    grid).  Every world rank calls it; the others get None.  `device` as in
    :func:`build_mesh`."""
    return build_mesh((1, 1), ranks=[0], device=device)
