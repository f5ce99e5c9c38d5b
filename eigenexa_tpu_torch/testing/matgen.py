"""Test-matrix generators with known spectra (counterpart of
``eigenexa_tpu/testing/matgen.py``; reference: benchmark/mat_set.f:41
``mat_set`` and :606 ``w_set``).

Types ported so far:

  0  Frank matrix            A[i,j] = min(i,j)+1 (0-based), eigenvalues
                             w_k = 1/(2(1-cos θ)) = 1/(4 sin²(θ/2)),
                             θ = π(2j+1)/(2n+1)
  2  Random symmetric        U(0,1) + transpose, from a numpy seed

Besides, ``helmert_matrix`` and ``designed`` (A = Hᵀ·diag(w)·H, an exact
spectrum; the GEV driver's B).  The designed-spectrum types 4-10
(``w_set``), Toeplitz and Frank2 wait (ROADMAP A2).
Random inputs come from ``numpy.random.default_rng(seed)``, never from a
global torch RNG, so both packages can be fed the same matrix.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def frank_spectrum(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Exact Frank-matrix eigenvalues, ascending (reference:
    benchmark/mat_set.f:638-649).  Taken as 1/(4 sin²(θ/2)): the
    reference's 1/(2(1 − cos θ)) loses digits to cancellation at small θ,
    the largest eigenvalues, 4.6e-6 of absolute error at n = 2048 and
    0.044 at n = 8192, far above what an f64 solve gets wrong."""
    i = np.arange(1, n + 1, dtype=np.float64)
    theta = np.pi * (2 * (n - i) + 1) / (2 * n + 1)
    w = 0.25 / np.sin(0.5 * theta) ** 2
    return torch.as_tensor(w, dtype=dtype, device=device)


def frank(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Frank matrix built on ``device`` in the target dtype (no int64
    n×n intermediate)."""
    i = torch.arange(n, dtype=dtype, device=device)
    return torch.minimum(i[:, None], i[None, :]) + 1


def frank_hermitian(n: int, dtype=torch.complex128, seed: int = 0,
                    device=None) -> torch.Tensor:
    """A = D·F·Dᴴ with F the Frank matrix and D = diag(e^{iφ}), φ ~ U(0, 2π)
    from ``numpy.random.default_rng(seed)``: Hermitian with complex entries
    off the diagonal and Frank's exact spectrum (``frank_spectrum``).
    Entry (i, j) is F[i, j]·e^{i(φ_i − φ_j)}, built on ``device``; the upper
    triangle is mirrored, so A is exactly Hermitian with a real
    diagonal."""
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    phi = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.0, 2.0 * np.pi, n), dtype=torch.float64, device=device)
    a = torch.polar(frank(n, torch.float64, device),
                    phi[:, None] - phi[None, :])
    a = torch.triu(a) + torch.triu(a, 1).conj().T
    a.diagonal().imag.zero_()
    return a.to(rdtype.to_complex())


def random_symmetric(n: int, dtype=torch.float64, seed: int = 0,
                     device=None) -> torch.Tensor:
    u = np.random.default_rng(seed).uniform(size=(n, n))
    return torch.as_tensor(u + u.T, dtype=dtype, device=device)


def helmert_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Helmert orthogonal matrix H (rows orthonormal).  Row 0: 1/√n; row
    i > 0: 1/√(i(i+1)) for k < i, −i/√(i(i+1)) at k = i, 0 for k > i
    (reference: benchmark/mat_set.f:395-424, 0-based here).  The 2n row
    values are computed by numpy in f64, as the JAX package computes them
    (its bits), and the n×n matrix is laid out on ``device``."""
    i = np.arange(n, dtype=np.float64)
    denom = np.sqrt(np.maximum(i * (i + 1), 1.0))
    below = torch.as_tensor(1.0 / denom, device=device)[:, None]
    diag = torch.as_tensor(-i / denom, device=device)[:, None]
    r = torch.arange(n, device=device)
    h = torch.where(r[None, :] < r[:, None], below,
                    torch.where(r[None, :] == r[:, None], diag, 0.0))
    h[0, :] = 1.0 / math.sqrt(n)
    return h.to(dtype)


def designed(w, dtype=torch.float64, seed: int = 0, perm=None,
             device=None) -> torch.Tensor:
    """A = Hᵀ·diag(ws)·H·s with the exact spectrum ``w`` (reference:
    benchmark/mat_set.f:337 helmert_trans): s = max(max|w|, 1), ws the
    values w/s in the order ``perm`` (default: a permutation drawn from
    ``numpy.random.default_rng(seed)``; the JAX package draws it from a
    jax key, which a parity test hands over here), H the Helmert matrix.
    Built on ``device``."""
    w = torch.as_tensor(w, dtype=dtype, device=device)
    n = w.shape[0]
    scale = torch.clamp_min(w.abs().amax(), 1.0)
    if perm is None:
        perm = np.random.default_rng(seed).permutation(n)
    ws = (w / scale)[torch.as_tensor(np.array(perm, dtype=np.int64),
                                     device=w.device)]
    h = helmert_matrix(n, dtype, w.device)
    return ((h.T * ws[None, :]) @ h) * scale


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
