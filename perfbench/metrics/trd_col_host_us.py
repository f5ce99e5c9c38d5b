"""trd_col_host_us: host microseconds a column of the tridiagonal
reduction, for the traced window's solves: the window's mean TRD-BLK
seconds (the stage region, host-paced: the card idles most of it) times
the share of the TRD-BLK span that the ``trd.column`` spans
(``ops/householder.py``) take in the profiled solve of
``spantrace.collect``, over that solve's columns.  The share comes from a
solve of its own because the record keeps no window solve's spans; that
solve runs after the harness's ``torch.profiler`` session, at a host pace
about 1.5 times slower than the window's on an H100's host, which the
share cancels and a plain mean of its spans would not.  A column's span
holds its host work and no barrier, so this is what a launch route (CUDA
graphs, fewer launches) has to shorten."""

from perfbench import spantrace
from perfbench.metrics import stage_mean


def read(rec):
    spantrace.collect(rec)
    mean = stage_mean(rec, "TRD-BLK")
    solves = [s for s in rec["spans"] or ()
              if "trd.column" in s and "TRD-BLK" in s]
    if not solves or not mean:
        return None
    columns = sum(s["trd.column"]["host_s"] for s in solves)
    stage = sum(s["TRD-BLK"]["host_s"] for s in solves)
    count = sum(s["trd.column"]["count"] for s in solves) / len(solves)
    return 1e6 * mean * (columns / stage) / count
