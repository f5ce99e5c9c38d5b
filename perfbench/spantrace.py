"""The program's spans in a ``--trace 1`` run (``utils/profiler.py`` of the
port: ``profiler.span`` where the work happens, folded into
``SolveInfo.spans``), read by the span metrics' readers.

:func:`collect` runs, once a run and after the harness's own profiled
solve, two more solves of the cell's routine and mode:

1. one with ``profile=True``: its ``SolveInfo.spans``, the spans' host
   times, go to ``rec["spans"]`` (a list, one entry a solve);
2. one with ``profile=Profiler(annotate=True)`` under ``torch.profiler``
   with CPU and CUDA activity: each span is a ``record_function`` range
   there, on the clock of the runtime's launches, and a launch's
   correlation id names the device operation it started.  Each device
   operation is put down to the innermost span open at its launch; the
   result is ``rec["span_trace"]`` (:func:`attribute`).

Both solve one matrix of the cell's kind made from ``SEED``: a reader
gets the record alone, which carries no seed, and the reduction's work
does not depend on the matrix.  The annotated solve's merges also count
their coordinates (``SolveInfo.counters``), inside spans of their own,
``dc.count``, whose kernels the readers leave out.  A program without
spans (no ``profiler.span``) leaves both keys None, and the readers then
return None.  :func:`log_table` writes the operator's view to stderr.
"""

from __future__ import annotations

import time
from collections import defaultdict

from perfbench import devtrace

SEED = 1_000_003
COUNT_SPAN = "dc.count"
OUTSIDE = "(outside spans)"
# the runtime and driver calls on the host (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...), which share a correlation id with what they start
LAUNCH_PREFIX = "cu"


def ranges_session(cuda: bool):
    """A ``torch.profiler`` session of the host's ``record_function``
    ranges alone and, on a card, the device's activity and the runtime's
    launches: ``torch.autograd.profiler.profile`` started with the user
    scope (``RecordScope.USER_SCOPE``), so it records no torch op.  At n =
    8192 that is about 1.1 M events fewer than the session with CPU
    activity, and it is read in half the time.  Where this torch lacks the
    entry points, the session with CPU activity (ranges and ops)."""
    import torch.autograd.profiler as ap
    from torch.profiler import ProfilerActivity, profile

    if (hasattr(ap, "_run_on_profiler_start")
            and "scopes" in (getattr(ap, "_enable_profiler", None).__doc__
                             or "")):
        from torch._C._profiler import RecordScope

        class Ranges(ap.profile):
            def _start_trace(self):
                self.entered = True
                ap._run_on_profiler_start()
                ap._enable_profiler(self.config(create_trace_id=False),
                                    self.kineto_activities,
                                    {RecordScope.USER_SCOPE})
                self.profiling_start_time_ns = time.perf_counter_ns()

        return Ranges(use_device="cuda" if cuda else None, use_kineto=True)
    return profile(activities=[ProfilerActivity.CPU]
                   + [ProfilerActivity.CUDA] * cuda)


def profile_spans(fn, device):
    """Run ``fn()`` once under :func:`ranges_session`.  Returns (ranges,
    ops, wall_s): the ``record_function`` ranges as (name, start_s, end_s),
    the device operations as (name, start_s, end_s, launch_s), launch_s
    the start of the runtime call that launched it (None where the trace
    has none), and the call's wall."""
    import torch
    from torch.autograd import DeviceType

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    with ranges_session(cuda) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ranges, device_ops, launched = [], [], {}
    for e in getattr(prof, "profiler", prof).kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            # the ranges' device-side copies (gpu_user_annotation) are left
            # out: they are no operation of the device
            if not e.is_user_annotation():
                device_ops.append((e.name(), e.start_ns(),
                                   e.start_ns() + e.duration_ns(),
                                   e.correlation_id()))
        elif e.is_user_annotation():
            ranges.append((e.name(), e.start_ns() * 1e-9,
                           (e.start_ns() + e.duration_ns()) * 1e-9))
        elif e.name().startswith(LAUNCH_PREFIX) and "::" not in e.name():
            launched[e.correlation_id()] = e.start_ns()
    ops = []
    for name, s, t, corr in device_ops:
        at = launched.get(corr)
        ops.append((name, s * 1e-9, t * 1e-9,
                    None if at is None else at * 1e-9))
    ops.sort(key=lambda op: op[1])
    return ranges, ops, wall


def nest(ranges) -> list:
    """(name, start_s, end_s, parent) of each range, in start order, the
    parent the innermost range that holds it (−1 for none).  Ranges of one
    thread nest."""
    out, stack = [], []
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and out[stack[-1]][2] < s:
            stack.pop()
        out.append((name, s, e, stack[-1] if stack else -1))
        stack.append(len(out) - 1)
    return out


def innermost(spans, times) -> list:
    """The index of the innermost span of ``spans`` (:func:`nest`'s form)
    open at each of ``times`` (−1 for none, and for a time that is None)."""
    out = [-1] * len(times)
    order = sorted((t, i) for i, t in enumerate(times) if t is not None)
    stack, k = [], 0
    for t, i in order:
        while k < len(spans) and spans[k][1] <= t:
            while stack and spans[stack[-1]][2] < spans[k][1]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[i] = stack[-1] if stack else -1
    return out


def attribute(ranges, ops) -> dict:
    """``rec["span_trace"]``: {"spans": [(name, start_s, end_s, parent)],
    "ops": [(name, start_s, end_s, span)]}, each device operation with the
    innermost span open at its launch (−1 outside every span, or where its
    launch is not in the trace)."""
    spans = nest(ranges)
    where = innermost(spans, [op[3] for op in ops])
    return {"spans": spans,
            "ops": [(name, s, e, at) for (name, s, e, _), at
                    in zip(ops, where)]}


def within(trace: dict, name: str) -> list:
    """Per span of the trace: whether it is ``name`` or lies inside one."""
    inside = []
    for span_name, _, _, parent in trace["spans"]:
        inside.append(span_name == name or (parent >= 0 and inside[parent]))
    return inside


def ops_within(trace: dict, name: str) -> list:
    """The device operations launched inside a span ``name`` (in it or in
    a span it holds), those of the counters' spans left out."""
    inside = within(trace, name)
    spans = trace["spans"]
    return [op for op in trace["ops"]
            if op[3] >= 0 and inside[op[3]] and spans[op[3]][0] != COUNT_SPAN]


def busy_s(ops) -> float:
    """``devtrace.busy_s`` of the trace's operations (in start order)."""
    return devtrace.busy_s(op[:3] for op in ops)


def span_count(trace: dict, name: str) -> int:
    return sum(1 for s in trace["spans"] if s[0] == name)


def _by_innermost(trace: dict) -> dict:
    """{span name or OUTSIDE: [ops launched with it innermost]}."""
    groups = defaultdict(list)
    for op in trace["ops"]:
        at = op[3]
        groups[OUTSIDE if at < 0 else trace["spans"][at][0]].append(op)
    return groups


def idle_by_span(trace: dict) -> dict:
    """The device's idle gaps in seconds, each put down to the innermost
    span open on the host when the gap ended (OUTSIDE for none)."""
    gaps, ends, end = [], [], None
    for _, s, e, _ in trace["ops"]:
        if end is not None and s > end:
            gaps.append(s - end)
            ends.append(s)
        end = e if end is None else max(end, e)
    out = defaultdict(float)
    for gap, at in zip(gaps, innermost(trace["spans"], ends)):
        out[OUTSIDE if at < 0 else trace["spans"][at][0]] += gap
    return out


def table(trace: dict, host: dict) -> list:
    """Rows of the operator's view, one a span name in order of first
    opening and one for OUTSIDE: (name, spans, host self µs a span,
    kernels with it innermost, kernels a span, device busy s, idle s)."""
    groups = _by_innermost(trace)
    idle = idle_by_span(trace)
    names = list(dict.fromkeys(s[0] for s in trace["spans"])) + [OUTSIDE]
    rows = []
    for name in names:
        count = span_count(trace, name)
        row = host.get(name)
        self_us = (1e6 * row["self_s"] / row["count"]
                   if row and row["count"] else None)
        ops = groups.get(name, [])
        kernels = sum(devtrace.is_kernel(op[0]) for op in ops)
        rows.append((name, count, self_us, kernels,
                     kernels / count if count else None,
                     busy_s(ops), idle.get(name, 0.0)))
    return rows


def log_table(rec: dict, log) -> None:
    """The per-span table and the checks of the annotated solve, to
    ``log``."""
    trace, host = rec["span_trace"], rec["spans"][0]
    log(f"spans: {trace['collect_s']} s in all: the clean profiled solve "
        f"{trace['clean_s']} s, the annotated solve {trace['wall_s']} s, "
        f"its attribution {trace['read_s']} s")
    log("spans: name | spans | host self us a span (clean solve) | kernels "
        "(innermost) | kernels a span | device busy s | idle s ending in it")
    for name, count, self_us, kernels, per, busy, idle in table(trace, host):
        log(f"spans: {name} | {count} | {self_us} | {kernels} | {per} | "
            f"{busy} | {idle}")
    kernels = [op for op in trace["ops"] if devtrace.is_kernel(op[0])]
    counted = sum(1 for op in kernels
                  if op[3] >= 0 and trace["spans"][op[3]][0] == COUNT_SPAN)
    outside = sum(1 for op in kernels if op[3] < 0)
    plain = sum(1 for op in rec["ops"] if devtrace.is_kernel(op[0]))
    log(f"spans: kernels {len(kernels)}, in {COUNT_SPAN} {counted}, the "
        f"rest {len(kernels) - counted} against the profiled solve's "
        f"{plain}; outside every span {outside} "
        f"({100.0 * outside / max(len(kernels), 1)}%)")
    col = host.get("trd.column")
    if col:
        parts = col["self_s"] + sum(
            row["self_s"] for name, row in host.items()
            if name.startswith("trd.column."))
        log(f"spans: trd.column host {col['host_s']} s; its self and its "
            f"sub-spans' self times {parts} s")
    counters = trace["counters"]
    if counters.get("dc.coords"):
        log(f"spans: counters {counters}; deflated share "
            f"{counters['dc.deflated'] / counters['dc.coords']}")


def collect(rec: dict, log=None):
    """``rec["span_trace"]``, made on the first call of a run (see the
    module's docstring); None on the CPU, where the traced run has no
    device trace, or for a program without spans."""
    if "span_trace" in rec:
        return rec["span_trace"]
    t_start = time.perf_counter()
    rec["span_trace"] = rec["spans"] = None
    if not rec["ops"]:
        return None
    from eigenexa_tpu_torch.utils import profiler

    if not hasattr(profiler, "span"):
        return None
    import torch

    from perfbench import gen, harness

    device = torch.device("cuda:0")
    solve, _ = harness.solver(
        {"config": rec["config"], "traffic": rec["traffic"]}, device)
    a = gen.make_matrix(rec["traffic"]["matrix"], rec["n"], rec["dtype"],
                        SEED, device)
    t0 = time.perf_counter()
    rec["spans"] = [solve(a, True)[2].spans]
    clean_s = time.perf_counter() - t0
    infos = []
    ranges, ops, wall = profile_spans(
        lambda: infos.append(solve(a, profiler.Profiler(annotate=True))[2]),
        device)
    t0 = time.perf_counter()
    trace = attribute(ranges, ops)
    trace.update(wall_s=wall, clean_s=clean_s, counters=infos[0].counters,
                 read_s=time.perf_counter() - t0,
                 collect_s=time.perf_counter() - t_start)
    rec["span_trace"] = trace
    del a
    log_table(rec, log or harness.log)
    return trace


def stage_idle(rec: dict, region: str):
    """100·(1 − the busy seconds of the device operations launched inside
    the annotated solve's span ``region`` ÷ the traced window's mean
    seconds of the stage region of that name), or None."""
    from perfbench.metrics import stage_mean

    trace = collect(rec)
    mean = stage_mean(rec, region)
    if not trace or not mean or not span_count(trace, region):
        return None
    return 100.0 * (1.0 - busy_s(ops_within(trace, region)) / mean)
