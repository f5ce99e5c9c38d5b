"""prd_blk_idle: the share of the PRD-BLK stage in which the card runs
nothing, %: 1 − (the union of the device operations launched inside the
annotated solve's ``PRD-BLK`` span, ``spantrace.collect``) ÷ (the mean
PRD-BLK seconds of the traced window's solves), ``trd_blk_idle``'s method
for the band-2 reduction."""

from perfbench import spantrace


def read(rec):
    return spantrace.stage_idle(rec, "PRD-BLK")
