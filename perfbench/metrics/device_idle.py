"""device_idle: the share of a solve in which the card runs nothing, %:
1 − (the union of the profiled solve's device operations) ÷ (the mean
wall of the traced window's solves, which ran without the profiler, whose
host-side bookkeeping of some 0.5 M launches would stretch the wall)."""

from perfbench.devtrace import busy_s
from perfbench.metrics import mean_wall


def read(rec):
    if not rec["ops"]:
        return None
    return 100.0 * (1.0 - busy_s(rec["ops"]) / mean_wall(rec))
