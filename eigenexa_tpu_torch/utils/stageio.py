"""Stage-level persistence: save and load of reduced-band data (mode R).

Counterpart of ``eigenexa_tpu/utils/stageio.py``.  The reference's only
checkpoint mechanism is mode 'R': the benchmark reads precomputed
tridiagonal or pentadiagonal data from D.data / E.data / F.data and runs
ONLY the D&C stage (reference: src/eigen_sx.F:175-193).  Same contract:
plain-text files, one value a line, with the reference's names.  The text
holds 19 significant digits, so an f64 value comes back with its bits.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def save_stage_data(dirpath, d, e, e2=None) -> None:
    """Write D.data, E.data and, for a pentadiagonal, F.data (reference
    file names, src/eigen_sx.F:201-221)."""
    os.makedirs(dirpath, exist_ok=True)
    np.savetxt(os.path.join(dirpath, "D.data"), _host(d))
    np.savetxt(os.path.join(dirpath, "E.data"), _host(e))
    if e2 is not None:
        np.savetxt(os.path.join(dirpath, "F.data"), _host(e2))


def load_stage_data(dirpath, dtype=torch.float64, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Read D.data, E.data and F.data where it exists, as ``dtype``
    tensors on ``device``; returns (d, e1, e2 or None)."""
    def read(name):
        values = np.loadtxt(os.path.join(dirpath, name), ndmin=1)
        return torch.as_tensor(values, dtype=dtype, device=device)

    fpath = os.path.join(dirpath, "F.data")
    return (read("D.data"), read("E.data"),
            read("F.data") if os.path.exists(fpath) else None)
