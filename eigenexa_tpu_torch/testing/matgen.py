"""Test-matrix generators with known spectra (counterpart of
``eigenexa_tpu/testing/matgen.py``; reference: benchmark/mat_set.f:41
``mat_set`` and :606 ``w_set``).

Matrix types (``MATRIX_TYPES``):

  0  Frank matrix            A[i,j] = min(i,j)+1 (0-based), eigenvalues
                             w_k = 1/(2(1-cos θ)) = 1/(4 sin²(θ/2)),
                             θ = π(2j+1)/(2n+1)
  1  Toeplitz                diag -7.2, offdiag -3/(i-j)² (no known w)
  2  Random symmetric        U(0,1) + transpose, from a numpy seed
  3  Frank matrix 2          A[i,j] = n - max(i,j) (same spectrum as 0)
  4  designed  w_i = i                              (uniform gaps)
  5  designed  w_i = sin³(5π i/(n-1) + ε^{1/4})     (clustered ±1)
  6  designed  w_i = mod(i,5) + mod(i,2)            (high multiplicity)
  7  designed  w = Frank spectrum
  8  designed  w_i ~ U(0,1)
  9  designed  w_i ~ normal
  10 designed  w from a user-supplied array or W.dat file
  -1 / -2  A.mtx / B.mtx (Matrix Market) from the working directory

Types 4-10 build A = Hᵀ·diag(shuffle(w/s))·H·s with the Helmert matrix H
(``designed``), so the exact spectrum is an input.  Every matrix is built
on ``device`` in the target dtype.
Random inputs (types 2, 8 and 9, ``designed``'s permutation) come from
``numpy.random.default_rng(seed)``, never from a global torch RNG, so both
packages can be fed the same matrix; the JAX package draws them from jax
keys, which a parity test hands over as arrays (type 10's ``w_file``,
``designed(perm=...)``).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

MATRIX_TYPES = {
    0: "Frank",
    1: "Toeplitz",
    2: "RandomSymmetric",
    3: "Frank2",
    4: "DesignedLinear",
    5: "DesignedSin3",
    6: "DesignedMultiplicity",
    7: "DesignedFrankSpectrum",
    8: "DesignedUniform",
    9: "DesignedNormal",
    10: "DesignedFile",
}


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


def frank2(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """A[i,j] = n − max(i,j) (0-based): Frank's spectrum, built as
    ``frank`` is."""
    i = torch.arange(n, dtype=dtype, device=device)
    return n - torch.maximum(i[:, None], i[None, :])


def toeplitz(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """−7.2 on the diagonal, −3/(i−j)² off it, built in the target dtype
    (the JAX package's integer n×n difference would be 8 GB at n = 32768);
    (i−j)² is rounded once in that dtype, as the JAX package rounds it."""
    i = torch.arange(n, dtype=dtype, device=device)
    d = i[:, None] - i[None, :]
    d.mul_(d).diagonal().fill_(1.0)
    a = -3.0 / d
    del d
    a.diagonal().fill_(-7.2)
    return a


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


def w_set(n: int, mtype: int, dtype=torch.float64, w_file=None,
          device=None) -> torch.Tensor:
    """Designed spectra (reference: benchmark/mat_set.f:606 w_set), in
    ``dtype`` on ``device``.  ε is the dtype's own.  Type 8 draws from
    ``default_rng(8).uniform``, type 9 from ``default_rng(9)
    .standard_normal``; type 10 takes ``w_file``, an array or the path of a
    W.dat file, its first n values."""
    eps4 = torch.finfo(dtype).eps ** 0.25
    if mtype in (0, 3, 7):
        return frank_spectrum(n, dtype, device)
    if mtype == 4:
        return torch.arange(n, dtype=dtype, device=device)
    if mtype == 5:
        i = torch.arange(1, n + 1, dtype=dtype, device=device)
        theta = math.pi * 5 * i / (n - 1) + eps4
        s = torch.sin(theta)
        return s * s * s
    if mtype == 6:
        i = torch.arange(1, n + 1, device=device)
        return (i % 5 + i % 2).to(dtype)
    if mtype == 8:
        w = np.random.default_rng(8).uniform(size=n)
    elif mtype == 9:
        w = np.random.default_rng(9).standard_normal(n)
    elif mtype == 10:
        if w_file is None:
            raise ValueError("mtype 10 needs w_file (array or path to W.dat)")
        if isinstance(w_file, (str, os.PathLike)):
            w = np.loadtxt(w_file).reshape(-1)[:n]
        elif isinstance(w_file, torch.Tensor):
            return w_file.reshape(-1)[:n].to(device=device, dtype=dtype)
        else:
            w = np.asarray(w_file)[:n]
    else:
        raise ValueError(f"no designed spectrum for mtype {mtype}")
    return torch.as_tensor(w, dtype=dtype, device=device)


def mat_set(n: int, mtype: int = 0, dtype=torch.float64, seed: int = 0,
            device=None, w_file=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Generate test matrix ``mtype`` (``MATRIX_TYPES``, or −1/−2 for
    A.mtx/B.mtx in the working directory) on ``device``; returns (A, w_true
    ascending or None).  ``seed`` feeds type 2 and the permutation of
    types 4-10; ``w_file`` is type 10's spectrum."""
    if mtype == 0:
        return (frank(n, dtype, device),
                frank_spectrum(n, dtype, device))
    if mtype == 1:
        return toeplitz(n, dtype, device), None
    if mtype == 2:
        return random_symmetric(n, dtype, seed, device), None
    if mtype == 3:
        return frank2(n, dtype, device), frank_spectrum(n, dtype, device)
    if 4 <= mtype <= 10:
        w = w_set(n, mtype, dtype, w_file, device)
        return designed(w, dtype, seed, device=device), torch.sort(w).values
    if mtype in (-1, -2):
        # reference: mat_set.f:220-245 reads A.mtx for -1, B.mtx for -2
        path = "A.mtx" if mtype == -1 else "B.mtx"
        return load_matrix_market(path, dtype, device), None
    raise ValueError(f"unknown matrix type {mtype}")


def load_matrix_market(path, dtype=torch.float64,
                       device=None) -> torch.Tensor:
    """Matrix-Market input, symmetrized as A + Aᵀ where it is not
    symmetric already (reference: benchmark/mat_set.f:223-245, types
    -1/-2)."""
    import scipy.io

    m = scipy.io.mmread(path)
    a = np.asarray(m.todense() if hasattr(m, "todense") else m)
    if not np.allclose(a, a.T):
        a = a + a.T
    return torch.as_tensor(a, dtype=dtype, device=device)
