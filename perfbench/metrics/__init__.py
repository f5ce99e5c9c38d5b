"""One reader per metric: ``metrics/<name>.py`` defines ``read(rec)``,
which returns the metric's value, or None where the run holds nothing for
it to read (the harness then leaves the metric out of the line).

``rec``, the record of one run (``harness.run_cell``):

* ``config``, ``traffic``: the cell's two files; ``n``, ``dtype``;
* ``setup_s``: process start to the first timed solve;
* ``window_s``: start of the first timed solve to the end of the last;
  ``walls``: each timed solve's seconds; ``solves``: their number;
* ``stages``: each timed solve's ``SolveInfo.stages`` (filled with
  ``--trace 1``: {region: {"seconds", "flops"}});
* ``peak_bytes``: the allocator's peak over the window above what was
  allocated when it opened;
* ``ops``: ``(name, start_s, end_s)`` of every device operation of the
  profiled solve (``--trace 1`` on a card; else empty);
  ``profiled_wall_s``: that solve's wall; ``launches``: the program's
  ``kernels.LAUNCHES`` counted over it.

The helpers below are shared by the readers.
"""

from __future__ import annotations


def stage_mean(rec: dict, region: str):
    """Mean seconds of a program region a timed solve, where every timed
    solve has it."""
    seconds = [s[region]["seconds"] for s in rec["stages"] if region in s]
    if not seconds or len(seconds) != len(rec["stages"]):
        return None
    return sum(seconds) / len(seconds)


def mean_wall(rec: dict) -> float:
    return sum(rec["walls"]) / len(rec["walls"])
