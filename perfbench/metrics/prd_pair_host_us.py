"""prd_pair_host_us: host microseconds a reflector pair of the band-2
reduction, for the traced window's solves: the window's mean PRD-BLK
seconds times the share of the PRD-BLK span that the ``prd.pair`` spans
(``ops/band.py``) take in the profiled solve of ``spantrace.collect``,
over that solve's pairs.  ``trd_col_host_us``'s method, for the same
reason: that solve runs at a slower host pace than the window's, which
the share cancels.  A pair's span holds its host work and no barrier."""

from perfbench import spantrace
from perfbench.metrics import stage_mean


def read(rec):
    spantrace.collect(rec)
    mean = stage_mean(rec, "PRD-BLK")
    solves = [s for s in rec["spans"] or ()
              if "prd.pair" in s and "PRD-BLK" in s]
    if not solves or not mean:
        return None
    pairs = sum(s["prd.pair"]["host_s"] for s in solves)
    stage = sum(s["PRD-BLK"]["host_s"] for s in solves)
    count = sum(s["prd.pair"]["count"] for s in solves) / len(solves)
    return 1e6 * mean * (pairs / stage) / count
