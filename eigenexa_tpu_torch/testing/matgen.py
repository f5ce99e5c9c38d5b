"""Test-matrix generators with known spectra (counterpart of
``eigenexa_tpu/testing/matgen.py``; reference: benchmark/mat_set.f:41
``mat_set`` and :606 ``w_set``).

Types ported so far:

  0  Frank matrix            A[i,j] = min(i,j)+1 (0-based), eigenvalues
                             w_k = 1/(2(1-cos θ)), θ = π(2j+1)/(2n+1)
  2  Random symmetric        U(0,1) + transpose, from a numpy seed

The designed spectra (types 4-10), Toeplitz and Frank2 wait (ROADMAP A2).
Random inputs come from ``numpy.random.default_rng(seed)``, never from a
global torch RNG, so both packages can be fed the same matrix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def frank_spectrum(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Exact Frank-matrix eigenvalues, ascending
    (reference: benchmark/mat_set.f:638-649)."""
    i = np.arange(1, n + 1, dtype=np.float64)
    theta = np.pi * (2 * (n - i) + 1) / (2 * n + 1)
    w = 0.5 / (1.0 - np.cos(theta))
    return torch.as_tensor(w, dtype=dtype, device=device)


def frank(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Frank matrix built on ``device`` in the target dtype (no int64
    n×n intermediate)."""
    i = torch.arange(n, dtype=dtype, device=device)
    return torch.minimum(i[:, None], i[None, :]) + 1


def random_symmetric(n: int, dtype=torch.float64, seed: int = 0,
                     device=None) -> torch.Tensor:
    u = np.random.default_rng(seed).uniform(size=(n, n))
    return torch.as_tensor(u + u.T, dtype=dtype, device=device)


def mat_set(n: int, mtype: int = 0, dtype=torch.float64, seed: int = 0,
            device=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Generate test matrix ``mtype``; returns (A, w_true or None)."""
    if mtype == 0:
        return (frank(n, dtype, device),
                frank_spectrum(n, dtype, device))
    if mtype == 2:
        return random_symmetric(n, dtype, seed, device), None
    raise NotImplementedError(
        f"matrix type {mtype} is not ported yet (ROADMAP A2)")
