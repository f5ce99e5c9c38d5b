"""trd_blk_idle: the share of the TRD-BLK stage in which the card runs
nothing, %: 1 − (the union of the device operations launched inside the
annotated solve's ``TRD-BLK`` span, ``spantrace.collect``) ÷ (the mean
TRD-BLK seconds of the traced window's solves), ``device_idle``'s method
for one stage: the profiler stretches the annotated solve's own wall."""

from perfbench import spantrace


def read(rec):
    return spantrace.stage_idle(rec, "TRD-BLK")
