"""Named-region stage timer (counterpart of ``eigenexa_tpu/utils/profiler.py``;
reference: FS_prof, src/FS_prof.F90, and the TRD-BLK / D&C / TRDBAK lines
of src/eigen_s.F:180-276).

Every region names the device its work runs on.  A region on a CUDA
device is timed with CUDA events recorded on the current stream and waits
for its end event; a region on the CPU is timed with ``perf_counter``.  So
no region on the card is timed without a barrier.  Profiling is opt-in, so
unprofiled solves never wait.  A module-level profiler, off by default,
serves ``profile_region``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class Profiler:
    """Accumulating region timer with the FS_prof usage pattern:

        prof = Profiler()
        with prof.region("TRD-BLK", flops, device=a.device):
            ...
        prof.report()    # the table; returns {name: {seconds, count, ...}}
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.flops: Dict[str, float] = {}

    @contextlib.contextmanager
    def region(self, name: str, flops: float = 0.0, *, device):
        """Times the block's work on `device` (that of its tensors)."""
        if not self.enabled:
            yield
            return
        device = torch.device(device)
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


def stage(prof: Optional[Profiler], name: str, flops: float = 0.0, *,
          device):
    """``prof.region(name, flops, device=device)``, or a context that
    times nothing when ``prof`` is None: an unprofiled solve never waits."""
    if prof is None:
        return contextlib.nullcontext()
    return prof.region(name, flops, device=device)


_GLOBAL = Profiler(enabled=False)


def profile_region(name: str, flops: float = 0.0, *, device):
    """A region on the module's profiler, which times nothing until
    ``enable_global()``."""
    return _GLOBAL.region(name, flops, device=device)


def enable_global() -> Profiler:
    _GLOBAL.enabled = True
    return _GLOBAL


def global_profiler() -> Profiler:
    return _GLOBAL
