"""trdbak_s: seconds of the program's TRDBAK region a timed solve, the back-transform (solvers/trbak.py),
from the stage regions of a ``--trace 1`` run (``profile=True``)."""

from perfbench.metrics import stage_mean


def read(rec):
    return stage_mean(rec, "TRDBAK")
