"""WY-blocked Householder back-transform (trbakwy4 analogue).

Counterpart of ``eigenexa_tpu/solvers/trbak.py`` (reference:
eigen_common_trbakwy, src/trbakwy4.F:77).  One formulation: a reverse loop
over WY blocks of ``nb`` reflectors, each applied in place on the row view
``z[k:, :]`` (the large product through the ``sub_matmul`` kernel).  Peak
memory is Z + V.  The JAX package's unrolled / chunk+scan / column-chunked
split exists for XLA compile size and a 16 GB chip and is not ported.

Flop model: 2·nvec·n² (reference: src/eigen_s.F:248).
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops.householder import apply_wy_left, wy_t_factor
from eigenexa_tpu_torch.utils.profiler import span


def back_transform(z: torch.Tensor, v: torch.Tensor, tau: torch.Tensor,
                   nb: int = 128, donate: bool = False) -> torch.Tensor:
    """Z ← Q·Z where Q = H_0·…·H_{n-3} from `tridiagonalize`.

    ``z`` is (n, nvec), the eigenvectors of the tridiagonal matrix; returns
    the eigenvectors of A.  Blocks are applied in reverse order, so the
    product telescopes as Q = B_0·(B_1·(…·(B_L·Z))).  With ``donate=True``
    ``z`` is updated in place; otherwise it is copied first.
    """
    if not donate:
        z = z.clone()
    n = z.shape[0]
    # cover n-1 reflector columns: for real input tau[n-2] = 0 (a no-op),
    # but the Hermitian path uses reflector n-2 as the phase rotation that
    # makes the last sub-diagonal real, so the coverage is kept
    for k in reversed(range(0, max(n - 1, 0), nb)):
        b = min(nb, n - 1 - k)
        with span("trbak.block"):
            vb = v[k:, k:k + b]          # rows < k+1 are structurally zero
            t = wy_t_factor(vb, tau[k:k + b])
            apply_wy_left(z[k:, :], vb, t)
    return z
