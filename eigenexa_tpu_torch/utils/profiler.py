"""Named-region stage timer (counterpart of ``eigenexa_tpu/utils/profiler.py``;
reference: FS_prof, src/FS_prof.F90, and the TRD-BLK / D&C / TRDBAK lines
of src/eigen_s.F:180-276).

A region on a CUDA device is timed with CUDA events recorded on the current
stream and waits for its end event; on the CPU it is timed with
``perf_counter``.  Profiling is opt-in, so unprofiled solves never wait.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class Profiler:
    """Accumulating region timer:

        prof = Profiler()
        with prof.region("TRD-BLK", flops, device):
            ...
        prof.times, prof.flops    # seconds and model flops per region
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.flops: Dict[str, float] = {}

    @contextlib.contextmanager
    def region(self, name: str, flops: float = 0.0, device=None):
        device = torch.device(device) if device is not None else None
        if device is not None and device.type == "cuda":
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
        if flops:
            self.flops[name] = self.flops.get(name, 0.0) + flops

    def stages(self) -> dict:
        """``SolveInfo.stages``: {name: {"seconds", "flops"}} per region, in
        the order they were first timed."""
        return {name: {"seconds": seconds, "flops": self.flops.get(name, 0.0)}
                for name, seconds in self.times.items()}


def stage(prof: Optional[Profiler], name: str, flops: float = 0.0,
          device=None):
    """``prof.region(name, flops, device)``, or a context that times
    nothing when ``prof`` is None: an unprofiled solve never waits."""
    if prof is None:
        return contextlib.nullcontext()
    return prof.region(name, flops, device)
