"""dc_tree_idle: the share of the D&C stage in which the card runs
nothing, %: 1 − (the union of the device operations launched inside the
annotated solve's ``D&C`` span, the merges' counters left out,
``spantrace.collect``) ÷ (the mean D&C seconds of the traced window's
solves)."""

from perfbench import spantrace


def read(rec):
    return spantrace.stage_idle(rec, "D&C")
