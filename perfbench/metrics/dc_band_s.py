"""dc_band_s: seconds of the D&C region a timed solve of ``eigen_sx``, the
band-2 D&C with two rank-1 merges a join (solvers/dc_band.py over
ops/secular.py), from the stage regions of a ``--trace 1`` run."""

from perfbench.metrics import stage_mean


def read(rec):
    return stage_mean(rec, "D&C")
