"""dc_tree_s: seconds of the D&C region a timed solve of ``eigen_s``, the
tridiagonal D&C (solvers/dc_tree.py over ops/secular.py), from the stage
regions of a ``--trace 1`` run."""

from perfbench.metrics import stage_mean


def read(rec):
    return stage_mean(rec, "D&C")
