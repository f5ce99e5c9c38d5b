"""The one generator of the benchmark's inputs.

A traffic file's ``matrix`` object names a kind and its parameters, and
:func:`make_matrix` builds that matrix on the device from ``--seed``, with
a ``torch.Generator`` on that device and in a few large calls.  The same
seed on the same kind of device gives the same matrix, bit for bit.

Kinds (the reference's ``benchmark/mat_set.f`` types, frozen here):

* ``random_symmetric``: U(0, 1) + its transpose (type 2);
* ``designed``: A = Hᵀ·diag(w/s)·H·s with H the Helmert matrix and s =
  max(max|w|, 1) (``mat_set.f:337`` helmert_trans), the spectrum ``w``
  named by ``spectrum`` (``w_set``, ``mat_set.f:606``) and laid out in a
  permutation drawn from the seed.  A is symmetrised as (A + Aᵀ)/2, so
  both triangles hold the same bits.

Spectra: ``multiplicity`` w_i = mod(i,5) + mod(i,2) (type 6).  A mix that
needs another type adds its entry here.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"float64": torch.float64}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    that fits 64 bits, negative ones included)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def spectrum(name: str, n: int, device) -> torch.Tensor:
    """The designed spectrum ``name`` of order n, f64, unsorted."""
    if name == "multiplicity":
        i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
        return torch.remainder(i, 5) + torch.remainder(i, 2)
    raise ValueError(f"unknown spectrum {name!r}")


def helmert(n: int, device) -> torch.Tensor:
    """The Helmert orthogonal matrix, f64 (``mat_set.f:395-424``, 0-based):
    row 0 is 1/√n; row i > 0 holds 1/√(i(i+1)) left of the diagonal and
    −i/√(i(i+1)) on it."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    denom = torch.sqrt(torch.clamp_min(i * (i + 1), 1.0))
    r = torch.arange(n, device=device)
    h = torch.where(r[None, :] < r[:, None], (1.0 / denom)[:, None],
                    torch.where(r[None, :] == r[:, None],
                                (-i / denom)[:, None], 0.0))
    h[0, :] = 1.0 / math.sqrt(n)
    return h


def make_matrix(spec: dict, n: int, dtype: str, seed: int,
                device) -> torch.Tensor:
    """The n×n symmetric matrix that ``spec`` (a traffic file's
    ``matrix``) describes, in ``dtype`` on ``device``."""
    g = generator(seed, device)
    kind = spec["kind"]
    if kind == "random_symmetric":
        u = torch.rand((n, n), generator=g, dtype=torch.float64,
                       device=device)
        a = u + u.T
    elif kind == "designed":
        w = spectrum(spec["spectrum"], n, device)
        perm = torch.randperm(n, generator=g, device=device)
        scale = torch.clamp_min(w.abs().amax(), 1.0)
        h = helmert(n, device)
        a = (h.T * (w / scale)[perm][None, :]) @ h
        del h
        a = (a + a.T).mul_(0.5 * scale)
    else:
        raise ValueError(f"unknown matrix kind {kind!r}")
    return a.to(DTYPES[dtype])

