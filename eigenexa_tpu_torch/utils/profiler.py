"""Named-region stage timer and the port's spans and counters (counterpart
of ``eigenexa_tpu/utils/profiler.py``; reference: FS_prof,
src/FS_prof.F90, and the TRD-BLK / D&C / TRDBAK lines of
src/eigen_s.F:180-276).

Every region names the device its work runs on.  A region on a CUDA
device is timed with CUDA events recorded on the current stream and waits
for its end event; a region on the CPU is timed with ``perf_counter``.  So
no region on the card is timed without a barrier.  Profiling is opt-in, so
unprofiled solves never wait.

Spans and counters.  A driver called with ``profile=True`` makes a
:class:`Profiler` and makes it the *active* one for the solve
(:func:`active`).  :func:`span` and :func:`count`, called where the work
happens (the reduction's columns, the D&C's levels, the back-transform's
blocks), report to it:

* with no active profiler (every unprofiled solve) :func:`span` is one
  module-level check that returns a shared null context and :func:`count`
  returns at once: no clock is read, no tensor is made, nothing waits;
* with one, a span records its name, its parent span and its start and
  end on the host clock (``perf_counter_ns``), in memory, without a
  barrier; :meth:`Profiler.spans` folds them into {name: {"count",
  "host_s", "self_s"}}, self time being the span's time less what its
  child spans cover;
* only where the profiler was made with ``annotate=True`` does a span also
  open a ``torch.profiler.record_function`` range of its name, which puts
  the program's spans on the clock of the device operations in a
  ``torch.profiler`` trace, and only then do the D&C's merges count their
  coordinates (:func:`annotating`).

Every stage region opens a span of its own name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_ACTIVE: Optional["Profiler"] = None
_NULL = contextlib.nullcontext()


class Profiler:
    """Accumulating region timer with the FS_prof usage pattern:

        prof = Profiler()
        with prof.region("TRD-BLK", flops, device=a.device):
            ...
        prof.report()    # the table; returns {name: {seconds, count, ...}}

    and the store of the spans and counters of the solves it is active
    for.  ``annotate=True`` also opens a ``record_function`` range for
    every span (see the module's docstring)."""

    def __init__(self, enabled: bool = True, annotate: bool = False):
        self.enabled = enabled
        self.annotate = annotate
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.flops: Dict[str, float] = {}
        # [name, parent's index or -1, start ns, end ns], in opening order
        self.records: list = []
        self.counters: dict = {}
        self._open: list = []

    @contextlib.contextmanager
    def region(self, name: str, flops: float = 0.0, *, device):
        """Times the block's work on `device` (that of its tensors)."""
        if not self.enabled:
            yield
            return
        device = torch.device(device)
        with _Span(self, name):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(device))
                yield
                end.record(torch.cuda.current_stream(device))
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                yield
                seconds = time.perf_counter() - t0
        self.add(name, seconds, flops)

    def add(self, name: str, seconds: float, flops: float = 0.0):
        self.times[name] = self.times.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1
        if flops:
            self.flops[name] = self.flops.get(name, 0.0) + flops

    def stages(self) -> dict:
        """``SolveInfo.stages``: {name: {"seconds", "flops"}} per region, in
        the order they were first timed."""
        return {name: {"seconds": seconds, "flops": self.flops.get(name, 0.0)}
                for name, seconds in self.times.items()}

    def spans(self) -> dict:
        """``SolveInfo.spans``: {name: {"count", "host_s", "self_s"}}, in the
        order the names first opened (read once the spans have closed)."""
        cover = [0] * len(self.records)
        for _, parent, t0, t1 in self.records:
            if parent >= 0:
                cover[parent] += t1 - t0
        out: dict = {}
        for i, (name, _, t0, t1) in enumerate(self.records):
            row = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                        "self_s": 0.0})
            row["count"] += 1
            row["host_s"] += (t1 - t0) * 1e-9
            row["self_s"] += (t1 - t0 - cover[i]) * 1e-9
        return out

    def read_counters(self) -> dict:
        """``SolveInfo.counters``: {name: int}, each counter read from the
        device once."""
        return {name: int(value) for name, value in self.counters.items()}

    def report(self, printer=print) -> dict:
        """FS_prof_finalize-style table, the regions by name; returns
        {name: {"seconds", "count"[, "gflops"]}}."""
        rows = {}
        for name in sorted(self.times):
            t = self.times[name]
            row = {"seconds": t, "count": self.counts[name]}
            if name in self.flops and t > 0:
                row["gflops"] = self.flops[name] / t / 1e9
            rows[name] = row
        if printer is not None:
            width = max((len(n) for n in rows), default=10)
            printer(f"{'region'.ljust(width)}  seconds     count  GFLOP/s")
            for name, row in rows.items():
                g = (f"{row['gflops']:8.1f}" if "gflops" in row
                     else "       -")
                printer(f"{name.ljust(width)}  {row['seconds']:9.4f}  "
                        f"{row['count']:6d}  {g}")
        return rows

    def reset(self):
        self.times.clear()
        self.counts.clear()
        self.flops.clear()
        self.records.clear()
        self.counters.clear()
        self._open.clear()


class _Span:
    """One span of ``prof``: its record opens on entry and closes on exit,
    inside the ``record_function`` range where the profiler annotates."""

    __slots__ = ("prof", "name", "index", "range")

    def __init__(self, prof: Profiler, name: str):
        self.prof = prof
        self.name = name
        self.range = None

    def __enter__(self):
        prof = self.prof
        if prof.annotate:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = len(prof.records)
        prof.records.append([self.name, prof._open[-1] if prof._open else -1,
                             time.perf_counter_ns(), 0])
        prof._open.append(self.index)

    def __exit__(self, *exc):
        prof = self.prof
        prof.records[self.index][3] = time.perf_counter_ns()
        prof._open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span of the active profiler, or the shared null context where
    none is active."""
    if _ACTIVE is None:
        return _NULL
    return _Span(_ACTIVE, name)


def count(name: str, value) -> None:
    """Adds ``value`` (an int, or a 0-d tensor, summed on its device) to the
    active profiler's counter ``name``; nothing where none is active."""
    if _ACTIVE is None:
        return
    counters = _ACTIVE.counters
    counters[name] = counters[name] + value if name in counters else value


def annotating() -> bool:
    """Whether an active profiler annotates: the D&C counts its merges only
    then, so a profiled solve launches the kernels an unprofiled one does."""
    return _ACTIVE is not None and _ACTIVE.annotate


@contextlib.contextmanager
def active(prof: Optional[Profiler]):
    """Makes ``prof`` the active profiler for the block; with None (or a
    disabled profiler) the one active before, if any, stays active, so an
    unprofiled solve called by a profiled one reports to the caller's."""
    global _ACTIVE
    if prof is None or not prof.enabled:
        yield
        return
    before, _ACTIVE = _ACTIVE, prof
    try:
        yield
    finally:
        _ACTIVE = before


def for_solve(profile) -> Optional[Profiler]:
    """A driver's profiler from its ``profile`` argument: a
    :class:`Profiler` as given (``Profiler(annotate=True)`` asks for the
    ranges), a new one for True, none for False."""
    if isinstance(profile, Profiler):
        return profile
    return Profiler() if profile else None


def stage(prof: Optional[Profiler], name: str, flops: float = 0.0, *,
          device):
    """``prof.region(name, flops, device=device)``, or a context that
    times nothing when ``prof`` is None: an unprofiled solve never waits."""
    if prof is None:
        return contextlib.nullcontext()
    return prof.region(name, flops, device=device)
