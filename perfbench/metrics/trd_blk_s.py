"""trd_blk_s: seconds of the program's TRD-BLK region a timed solve, the tridiagonal reduction (ops/householder.py),
from the stage regions of a ``--trace 1`` run (``profile=True``)."""

from perfbench.metrics import stage_mean


def read(rec):
    return stage_mean(rec, "TRD-BLK")
