"""Shared fixtures of the benchmark's own tests (CPU unless marked
``gpu``).  Run from the root of the checkout:

    python -m pytest perfbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def small_spec():
    """spec(cell, n[, root][, mode]): the cell as the benchmark loads it,
    at order n, its traffic's mode replaced by ``mode`` where one is
    given (mode N of A-random is a mix no cell runs now, with the w_gap
    limit that A-random and the eigenvalues-only cell shared)."""
    def spec(cell: str, n: int, root: Path = ROOT, mode=None) -> dict:
        out = harness.load_cell(cell, root)
        out["config"]["n"] = n
        if mode is not None:
            out["traffic"]["mode"] = mode
        return out
    return spec


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
