"""Collectives over the solver mesh (counterpart of
``eigenexa_tpu/parallel/collectives.py``; reference: ``comm_mod``,
src/comm.F — bcast_dbl:726, reduce_dbl:1192, allgather_dbl:1278,
datacast_dbl:1377 — and the group allreduce of the FS merge tree,
src/MPI_Allreduce_group.F90:644,673).

Where the JAX package calls ``lax.psum`` or ``lax.all_gather`` on a mesh
axis inside ``shard_map``, the port calls ``all_reduce`` or ``all_gather``
on the mesh's process group of that axis ('x': the ranks of one grid
column, which shard rows; 'y': the ranks of one grid row, which shard
columns; ('x', 'y'): the whole grid).  Only two collectives are used:
``all_gather``, and ``all_reduce`` with MAX on real tensors.  A sum is an
all_gather of the ranks' pieces added on every rank in group order: the
same bits on every rank and in every run, and one round of messages where
a ring all_reduce takes two (gloo's latency sets the distributed
reduction's pace: a column makes seven collectives).  A broadcast is a
masked sum, as in the JAX package: the owner contributes its value and
every other rank zeros, so the sum is the owner's value exactly.

The functions are pure: they return a new tensor and leave their input as
it was.  Over a group of one rank each returns its input (or a copy of the
one piece), with no call: XLA elides those too.  The ranks of a group call
each collective in the same order; a rank outside it does not call it.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

GRID = ("x", "y")


def _group(mesh, axis):
    """(process group or None, its size, this rank's index along it)."""
    if axis == "x":
        return mesh.x_group, mesh.px, mesh.ix
    if axis == "y":
        return mesh.y_group, mesh.py, mesh.iy
    if tuple(axis) == GRID:
        return (mesh.grid_group if mesh.size > 1 else None, mesh.size,
                mesh.flat)
    raise ValueError(f"axis must be 'x', 'y' or ('x', 'y'), got {axis!r}")


def _sum(v: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of v: all_gather, then the pieces added in group
    order."""
    if group is None:
        return v
    v = v.contiguous()
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, v, group=group)
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


def psum_x(v, mesh):
    """Sum along the row axis (reduce_dbl on x_COMM_WORLD,
    src/comm.F:1192)."""
    return _sum(v, mesh.x_group)


def psum_y(v, mesh):
    """Sum along the column axis."""
    return _sum(v, mesh.y_group)


def psum_grid(v, mesh):
    """Sum over the whole grid (a reduce on TRD_COMM_WORLD,
    src/eigen_devel.F:53)."""
    return _sum(v, _group(mesh, GRID)[0])


def pmax(v, mesh, axis):
    """Allreduce-max along one axis, or the grid (the max-reduce of the
    distributed drivers' scaling, src/eigen_scaling.F:59).  Real tensors
    only."""
    if v.is_complex():
        raise TypeError("pmax: complex values have no order")
    group = _group(mesh, axis)[0]
    if group is None:
        return v
    out = v.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def bcast_from_owner(v, owned: bool, mesh, axis):
    """Broadcast from the one rank of the axis where `owned` is True (the
    masked-sum form of bcast_dbl from a computed root, src/comm.F:726)."""
    group, _, _ = _group(mesh, axis)
    if group is None:
        return v
    return _sum(v if owned else torch.zeros_like(v), group)


def bcast(v, mesh, axis, root: int = 0):
    """Broadcast from index `root` along one axis (bcast_dbl,
    src/comm.F:726)."""
    return bcast_from_owner(v, _group(mesh, axis)[2] == root, mesh, axis)


def all_gather(v, mesh, axis, tiled: bool = True):
    """Allgather along one axis or the grid (allgather_dbl,
    src/comm.F:1278): the pieces in the axis's index order (flat order
    ix·py + iy for the grid), concatenated along dim 0 (``tiled``) or
    stacked."""
    group, size, _ = _group(mesh, axis)
    v = v.contiguous()
    if group is None:
        return v.clone() if tiled else v[None].clone()
    parts = [torch.empty_like(v) for _ in range(size)]
    dist.all_gather(parts, v, group=group)
    if tuple(axis) == GRID:
        # the grid group lists its ranks by world rank: put them in flat
        # order
        flat = [ix * mesh.py + iy for ix, iy in mesh.grid_order]
        parts = [p for _, p in sorted(zip(flat, parts), key=lambda t: t[0])]
    return torch.cat(parts) if tiled else torch.stack(parts)


def datacast_block(v_local, mesh, from_axis: str, to_axis: str,
                   to_size: int):
    """The row ↔ column redistribution of the distributed TRD
    (datacast_dbl, src/comm.F:1377, called every panel column from
    src/eigen_trd_t2.F:161).  Under the block layout it is one tiled
    all_gather along `from_axis` and a slice: `v_local` (m_from, …) is this
    rank's block of a vector (or row stack) sharded along `from_axis`; the
    result (to_size, …) is the block this rank owns along `to_axis`."""
    full = all_gather(v_local, mesh, from_axis)
    start = _group(mesh, to_axis)[2] * to_size
    return full[start:start + to_size]


def datacast_block_and_sum(v_local, partial, mesh, from_axis: str,
                           to_axis: str, to_size: int):
    """:func:`datacast_block` of `v_local` and the sum of `partial` along
    `from_axis`, in one all_gather where they depend on nothing computed
    between them (the distributed reductions' v and its panel
    corrections).  Returns (the block, the sum); the sum adds the ranks'
    pieces in group order, the bits of :func:`psum_x` / :func:`psum_y`."""
    v_local = v_local.contiguous()
    nv = v_local.numel()
    pieces = all_gather(torch.cat([v_local.reshape(-1),
                                   partial.reshape(-1)]), mesh, from_axis,
                        tiled=False)
    full = pieces[:, :nv].reshape((-1,) + tuple(v_local.shape[1:]))
    start = _group(mesh, to_axis)[2] * to_size
    total = pieces[0, nv:].clone()
    for piece in pieces[1:, nv:]:
        total += piece
    return full[start:start + to_size], total.reshape(partial.shape)


def grouped_allreduce(v, gsz: int, mesh):
    """Allreduce-sum within contiguous groups of `gsz` flat ranks
    (flat = ix·py + iy): the FS merge tree's group-scoped reduce
    (MPI_Group_Allreduce, src/MPI_Allreduce_group.F90:644,673, used by
    FS_REDUCE_ZD.F90:98 and FS_PDLAED3.F90:367-411).

    A power-of-two `gsz` sums over the mesh's merge group of this rank
    (built once a mesh, ``mesh.merge_groups``); `gsz` = P is the grid.  Any other size keeps the JAX package's masked form
    (collectives.py:227): every rank puts its value in its group's slot of
    a (P, numel) zero matrix, one sum over the grid adds all groups at once,
    and each rank reads its own slot back."""
    p = mesh.size
    if gsz <= 1:
        return v
    if p % gsz:
        raise ValueError(f"group size {gsz} does not divide {p} ranks")
    if gsz == p:
        return psum_grid(v, mesh)
    if gsz in mesh.merge_groups:
        return _sum(v, mesh.merge_groups[gsz])
    gid = mesh.flat // gsz
    contrib = torch.zeros((p, v.numel()), dtype=v.dtype, device=v.device)
    contrib[gid] = v.reshape(-1)
    return psum_grid(contrib, mesh)[gid].reshape(v.shape)


class CommStats:
    """Collective accounting by category (bcast / reduce / redist), the
    reference's COMM_STAT tables (src/eigen_devel.F:98-117).

    The drivers fill it from the communication models of each stage
    (``trd_dist.comm_model_trd``, ``comm_model_trbak``,
    ``dc_dist.comm_model_dc``: every collective of the algorithm times its
    trip count), and :meth:`seconds` attributes time with the calibrated
    latency + per-byte model (:func:`calibrate_overheads`)."""

    def __init__(self):
        self.counts = {}
        self.bytes = {}

    def record(self, category: str, nbytes: int, count: int = 1):
        self.counts[category] = self.counts.get(category, 0) + count
        self.bytes[category] = self.bytes.get(category, 0) + nbytes

    def merge(self, other: "CommStats") -> "CommStats":
        for k in other.counts:
            self.record(k, other.bytes.get(k, 0), other.counts[k])
        return self

    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def total_count(self) -> int:
        return sum(self.counts.values())

    def seconds(self, latency_s: float, per_byte_s: float) -> float:
        """Model-attributed collective time (the a(3,1) analogue,
        src/eigen_s.F:284-295)."""
        return (self.total_count() * latency_s
                + self.total_bytes() * per_byte_s)

    def report(self):
        return {k: {"count": self.counts[k], "bytes": self.bytes[k]}
                for k in sorted(self.counts)}

    def stat_block(self, latency_s: float, per_byte_s: float):
        """The COMM_STAT text block: count, bytes, attributed time and GB/s
        a category (eigen_timer_print, src/eigen_devel.F:440-526)."""
        lines = ["COMM_STAT"]
        for k in sorted(self.counts):
            sec = self.counts[k] * latency_s + self.bytes[k] * per_byte_s
            gbs = self.bytes[k] / sec / 1e9 if sec > 0 else 0.0
            lines.append(
                f"  {k:8s} count {self.counts[k]:10d}   "
                f"bytes {self.bytes[k]:14d}   time {sec:10.6f} s   "
                f"{gbs:8.2f} GB/s")
        lines.append(
            f"  {'total':8s} count {self.total_count():10d}   "
            f"bytes {self.total_bytes():14d}   "
            f"time {self.seconds(latency_s, per_byte_s):10.6f} s")
        return lines


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chain_seconds(step, reps: int, device) -> float:
    """Wall seconds of `reps` calls of step(), the device drained before
    and after; the least of three runs."""
    best = float("inf")
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate_overheads(mesh) -> tuple:
    """(latency_s, per_byte_s) of a collective on this mesh, by timed
    sampling: the eigen_init-time calibration of the reference
    (src/eigen_libs0.F:774-849; JAX ``calibrate_overheads``).

    Every rank of the mesh calls it.  Latency: the slope of chains of 16
    and 128 all_gathers of 8 float32 values a rank over the grid group
    (the collective of every sum and broadcast of the solve), less the
    slope of the same loop without the collective; per byte: the slope of
    chains of 4 and 16 all_gathers of 1 MiB over the grid group, less the
    latency.  The JAX package probes its one fused program and returns 0 on
    one device; here every collective is its own call, and a 1×1 mesh
    times its one-rank communicator too.  Both values are floored as the
    JAX package floors them (100 ns, 1 TB/s) and the grid's largest is
    returned on every rank."""
    dev = mesh.device
    group = mesh.grid_group
    p = mesh.size
    small = torch.ones(8, dtype=torch.float32, device=dev)
    small_parts = [torch.empty_like(small) for _ in range(p)]
    piece = torch.ones(max((1 << 18) // p, 1), dtype=torch.float32,
                       device=dev)
    parts = [torch.empty_like(piece) for _ in range(p)]

    def reduce_step():
        dist.all_gather(small_parts, small, group=group)
        small.mul_(1.0 / p)

    def noop_step():
        small.mul_(1.0 / p).mul_(p)

    def gather_step():
        dist.all_gather(parts, piece, group=group)

    def slope(step, lo, hi):
        step()
        return max(_chain_seconds(step, hi, dev)
                   - _chain_seconds(step, lo, dev), 0.0) / (hi - lo)

    s_reduce = slope(reduce_step, 16, 128)
    s_noop = slope(noop_step, 16, 128)
    latency = max(s_reduce - s_noop, 0.25 * s_reduce, 1e-7)
    per_gather = slope(gather_step, 4, 16)
    per_byte = max(max(per_gather - latency, 0.0) / (piece.numel() * p * 4),
                   1e-12)
    out = torch.tensor([latency, per_byte], dtype=torch.float64, device=dev)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return float(out[0]), float(out[1])
