"""Shared helpers of the port's parity tests (not collected: no test_
prefix).

Inputs are made with ``numpy.random.default_rng(seed)`` and handed as the
same numpy arrays to the JAX function (run as the JAX package's own tests
run it: on the CPU, Pallas in interpret mode) and to the port's counterpart
on the CPU; results come back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

# The suite runs several test processes side by side on shared cores; the
# port's CPU tests work at n ≤ 256, where extra intra-op threads only
# oversubscribe the cores the JAX tests are using.
torch.set_num_threads(1)


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def sym(n: int, seed: int) -> np.ndarray:
    """Random symmetric matrix (f64)."""
    u = rng(seed).standard_normal((n, n))
    return u + u.T


def t(x, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (a copy, so in-place port code cannot alias the
    array handed to JAX)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def n_(x) -> np.ndarray:
    """Tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clusters(w: np.ndarray, gap: float):
    """Index ranges of ascending w whose neighbours lie within `gap`."""
    out, start = [], 0
    for i in range(1, len(w) + 1):
        if i == len(w) or w[i] - w[i - 1] > gap:
            out.append((start, i))
            start = i
    return out


def assert_same_eigenspaces(z1, z2, w, tol: float, gap: float):
    """Eigenvectors compared through the projectors of each eigenvalue
    cluster — invariant to column signs and to the basis inside a cluster
    (LAPACK, cuSOLVER and the two packages may pick either)."""
    z1, z2, w = n_(z1), n_(z2), np.sort(n_(w))
    worst = 0.0
    for a, b in clusters(w, gap):
        p1 = z1[:, a:b] @ z1[:, a:b].T
        p2 = z2[:, a:b] @ z2[:, a:b].T
        worst = max(worst, float(np.abs(p1 - p2).max()))
    assert worst < tol, (worst, tol)
