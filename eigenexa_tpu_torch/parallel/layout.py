"""Index algebra of distributed matrix layouts (counterpart of
``eigenexa_tpu/parallel/layout.py``; reference: the cyclic(1) helpers
eigen_loop_start / eigen_loop_end / eigen_translate_l2g / g2l /
eigen_owner_node / eigen_owner_index, src/eigen_libs0.F:1816-2238, and
``eigen_get_matdims0``, src/eigen_libs0.F:1254).

All indices are 0-based.  Global element A(j, i) lives on the process at
(j % x_nnod, i % y_nnod) under cyclic(1) (the reference's convention).  The
port's drivers use the block layout of ``parallel/distributed.py``
(``padded_size``); these helpers serve ``EigenContext.matdims`` and the
runtime queries.  The ``SUBLANE`` × ``LANE`` round-up of the local
dimensions is the JAX package's (its TPU tile), kept so that
``eigen_get_matdims`` answers as the reference package does.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Index = Union[int, torch.Tensor]

LANE = 128      # local column count rounded up to this
SUBLANE = 8     # local row count rounded up to this


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cyclic_owner(g: Index, p: int, b: int = 1) -> Index:
    """Owner shard of global index g under block-cyclic(b) over p shards
    (eigen_owner_node, src/eigen_libs0.F:2154)."""
    return (g // b) % p


def cyclic_g2l(g: Index, p: int, b: int = 1) -> Index:
    """Local index on the owner shard (eigen_owner_index,
    src/eigen_libs0.F:2238)."""
    return (g // (b * p)) * b + g % b


def cyclic_l2g(l: Index, rank: Index, p: int, b: int = 1) -> Index:
    """Global index of local element l on shard `rank`
    (eigen_translate_l2g, src/eigen_libs0.F:1986)."""
    return (l // b) * (b * p) + rank * b + l % b


def cyclic_local_count(n: int, rank: int, p: int, b: int = 1) -> int:
    """Number of global indices in [0, n) owned by `rank`
    (eigen_loop_end − eigen_loop_start + 1, src/eigen_libs0.F:1816,1902)."""
    full, rem = divmod(n, b * p)
    cnt = full * b
    extra = rem - rank * b
    if extra > 0:
        cnt += min(extra, b)
    return cnt


def cyclic_local_size(n: int, p: int, b: int = 1) -> int:
    """Max local count over shards: the padded local dimension."""
    return cyclic_local_count(n, 0, p, b)


def cyclic_indices(n_local: int, rank: int, p: int, b: int = 1
                   ) -> torch.Tensor:
    """Global indices (possibly ≥ n: the caller masks) of the local
    rows or columns."""
    return cyclic_l2g(torch.arange(n_local), rank, p, b)


def padded_local_dims(n: int, px: int, py: int, b: int = 1,
                      tile: int = LANE) -> Tuple[int, int]:
    """Per-shard (rows, cols) of an n×n matrix on a px×py grid under
    cyclic(b): rows rounded up to ``SUBLANE``, columns to `tile`
    (eigen_get_matdims0, src/eigen_libs0.F:1254)."""
    lr = round_up(max(cyclic_local_size(n, px, b), 1), SUBLANE)
    lc = round_up(max(cyclic_local_size(n, py, b), 1), tile)
    return lr, lc


def check_int32_overflow(n: int, lr: int, lc: int) -> None:
    """Refuse a local block whose element count does not fit int32
    indexing (the reference's 32-bit overflow check,
    src/eigen_libs0.F:1345-1365)."""
    if lr * lc >= 2 ** 31:
        raise ValueError(f"local block {lr}x{lc} exceeds int32 element "
                         "indexing; use a larger mesh")
