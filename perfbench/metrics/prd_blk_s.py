"""prd_blk_s: seconds of the program's PRD-BLK region a timed solve of
``eigen_sx``, the pentadiagonal reduction by reflector pairs
(ops/band.py), from the stage regions of a ``--trace 1`` run
(``profile=True``)."""

from perfbench.metrics import stage_mean


def read(rec):
    return stage_mean(rec, "PRD-BLK")
