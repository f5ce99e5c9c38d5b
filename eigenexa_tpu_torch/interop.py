"""Parameters and arrays carried across from the JAX package.

No jax import: a JAX ``SolverConfig`` is read as a dataclass, and arrays
cross as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eigenexa_tpu_torch.runtime import SolverConfig


def config_from_jax(cfg) -> SolverConfig:
    """The port's SolverConfig from a JAX ``SolverConfig`` instance, field
    by field.  The JAX fields the port has no counterpart for are dropped
    (see :class:`SolverConfig`)."""
    src = dataclasses.asdict(cfg)
    return SolverConfig(**{f.name: src[f.name]
                           for f in dataclasses.fields(SolverConfig)})


def as_tensor(x, device=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``."""
    return torch.as_tensor(np.asarray(x), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device back as a numpy array."""
    return t.detach().cpu().numpy()
