"""The device trace of one solve: ``torch.profiler`` with CUDA activity
only, read back as plain ``(name, start_s, end_s)`` tuples of the device's
operations (kernels, copies and sets), and what the breakdown takes from
them.  The readers in ``metrics/`` work on these tuples alone, so they can
be tested on a recorded list."""

from __future__ import annotations

import time
from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")
NAMESPACES = ("at::native::", "(anonymous namespace)::", "std::", "at::",
              "c10::", "binary_internal::")


def profile_ops(fn, device):
    """Run ``fn()`` once under the profiler and drop its result.  Returns
    (ops sorted by start, the host wall of the call in seconds); the wall
    ends in a device barrier and leaves out the profiler's own start and
    stop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    ops = [(e.name(), e.start_ns() * 1e-9,
            (e.start_ns() + e.duration_ns()) * 1e-9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    ops.sort(key=lambda op: op[1])
    return ops, wall


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def busy_s(ops) -> float:
    """Seconds covered by the union of the operations' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in ops:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def short_name(name: str, width: int = 72) -> str:
    """A device operation's name without its return type, its argument
    list and the commonest namespaces, at most ``width`` characters: the
    template arguments stay, since they name the functor of an elementwise
    kernel."""
    if name.startswith(COPY_PREFIXES):
        return name[:width]
    if name.startswith("void "):
        name = name[5:]
    elif name.startswith("std::enable_if") and "::type " in name:
        name = name.split("::type ", 1)[1]
    for ns in NAMESPACES:
        name = name.replace(ns, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][:width]
    return name[:width]


def breakdown(ops, top: int = 10) -> dict:
    """The device operations that took most time, by short name, and the
    longest idle stretches, summed by the pair of operations around them:
    what the host was launching when the device waited."""
    by_op = defaultdict(float)
    for name, s, e in ops:
        by_op[short_name(name)] += e - s
    gaps = defaultdict(float)
    counts = defaultdict(int)
    end, prev = None, None
    for name, s, e in ops:
        if end is not None and s > end:
            key = f"{prev} -> {short_name(name)}"
            gaps[key] += s - end
            counts[key] += 1
        if end is None or e >= end:
            end, prev = e, short_name(name)
    lead = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in lead],
            "idle_gaps": [[f"{k} x{counts[k]}", v] for k, v in idle]}
