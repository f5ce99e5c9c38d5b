"""Divide & conquer solver for the reduced tridiagonal problem: the
dispatch facade (counterpart of ``eigenexa_tpu/solvers/dc.py``).

The default path is the batched tree D&C (solvers/dc_tree.py); the dense
``torch.linalg.eigh`` oracle stays for cross-checks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eigenexa_tpu_torch.solvers.dc_tree import solve_tridiag_dc


def assemble_tridiag(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    t = torch.diag(d)
    if d.shape[0] > 1:
        t = t + torch.diag(e, 1) + torch.diag(e, -1)
    return t


def solve_tridiag_dense(d: torch.Tensor, e: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: dense eigh of T.  Returns ascending (w, S) with
    T·S = S·diag(w) (reference: LAPACK_EIGEN2 / DSTEDC at P=1)."""
    return torch.linalg.eigh(assemble_tridiag(d, e))


def solve_tridiag(d, e, leaf: int = 32, vec_dtype=None):
    """Default reduced-problem solver: batched tree D&C.

    Returns ascending (w float64, S in vec_dtype)."""
    return solve_tridiag_dc(d, e, leaf=leaf, vec_dtype=vec_dtype)


def eigvals_tridiag_dense(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of T alone, ascending, from the dense eigvalsh of T in
    d's dtype (the JAX package's ``eigen_h`` mode N)."""
    return torch.linalg.eigvalsh(assemble_tridiag(d, e))
