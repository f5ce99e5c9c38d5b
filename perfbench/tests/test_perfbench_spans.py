"""The span metrics' readers (``metrics/trd_col_host_us.py``,
``trd_launches_per_col.py``, ``trd_blk_idle.py``, ``dc_tree_idle.py``)
and ``spantrace`` on recorded lists: ranges, device operations with their
launch times, and the host spans of a profiled solve, written out by
hand."""

import pytest

from perfbench import harness, spantrace

READERS = ("trd_col_host_us", "trd_launches_per_col", "trd_blk_idle",
           "dc_tree_idle")
GEMV = "void gemv2T_kernel_val<int, int, double>(double const*)"
COPY = "Memcpy DtoD (Device -> Device)"

# TRD-BLK [0, 10] holds a panel [0.5, 9] with two columns, the first with
# a sub-span; D&C [20, 30] holds a level with a counters' span
RANGES = [("TRD-BLK", 0.0, 10.0), ("trd.panel", 0.5, 9.0),
          ("trd.column", 1.0, 3.0), ("trd.column.form", 1.1, 1.5),
          ("trd.column", 4.0, 6.0), ("trd.update", 7.0, 8.0),
          ("D&C", 20.0, 30.0), ("dc.level", 21.0, 29.0),
          ("dc.count", 25.0, 26.0)]
# (name, device start, device end, launch): launched in form, in the first
# column, a copy in the second, in the update, in TRD-BLK alone, outside
# every span, in the level, in the counters' span, and one whose launch
# the trace lacks
OPS = [(GEMV, 1.3, 1.4, 1.2), (GEMV, 2.1, 2.3, 2.0), (COPY, 4.6, 4.7, 4.5),
       (GEMV, 4.8, 5.0, 4.6), (GEMV, 7.6, 8.6, 7.5), (GEMV, 9.6, 9.8, 9.5),
       (GEMV, 12.0, 12.5, 11.0), (GEMV, 22.0, 24.0, 21.5),
       (GEMV, 25.2, 25.3, 25.1), (GEMV, 31.0, 31.5, None)]


def record(root, ops=(), stages=None, spans=None, trace=None):
    spec = harness.load_cell("eigen_s-f64-n8192.A-random", root)
    rec = {"config": spec["config"], "traffic": spec["traffic"],
           "n": 8192, "dtype": "float64", "setup_s": 12.5, "window_s": 2.0,
           "walls": [1.0, 1.0], "solves": 2,
           "stages": stages or [{}, {}], "peak_bytes": 3 * 2 ** 30,
           "ops": list(ops), "launches": {}, "profiled_wall_s": 1.5}
    if trace is not None:
        rec["span_trace"], rec["spans"] = trace, spans
    return rec


def read(root, name, rec):
    return harness.reader(root / "perfbench" / "metrics", name)(rec)


def traced():
    trace = spantrace.attribute(RANGES, OPS)
    trace.update(wall_s=3.0, clean_s=1.0, read_s=0.1, collect_s=4.0,
                 counters={"dc.coords": 16, "dc.deflated": 4,
                           "dc.on_pole": 1})
    return trace


def test_nothing_to_read_gives_none(root, monkeypatch):
    # a run without a device trace (the CPU) runs no solve and reads None
    rec = record(root)
    for name in READERS:
        assert read(root, name, rec) is None
    assert rec["span_trace"] is None and rec["spans"] is None
    # a program without spans (the module has no ``span``) gives None too,
    # before any solve
    from eigenexa_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "span")
    rec = record(root, ops=[(GEMV, 0.0, 1.0)])
    for name in READERS:
        assert read(root, name, rec) is None
    # a trace without the spans a reader needs
    rec = record(root, ops=[(GEMV, 0.0, 1.0)], spans=[{}],
                 trace={"spans": [], "ops": [(GEMV, 0.0, 1.0, -1)]})
    for name in READERS:
        assert read(root, name, rec) is None


def test_a_launch_counts_for_its_innermost_span_only():
    trace = spantrace.attribute(RANGES, OPS)
    spans = trace["spans"]
    assert [s[0] for s in spans] == [r[0] for r in RANGES]
    assert [s[3] for s in spans] == [-1, 0, 1, 2, 1, 1, -1, 6, 7]
    where = ["outside" if op[3] < 0 else spans[op[3]][0]
             for op in trace["ops"]]
    assert where == ["trd.column.form", "trd.column", "trd.column",
                     "trd.column", "trd.update", "TRD-BLK", "outside",
                     "dc.level", "dc.count", "outside"]
    rows = {r[0]: r for r in spantrace.table(trace, {})}
    # kernels with the span innermost (copies not counted), and spans
    assert rows["trd.column.form"][3] == 1
    assert rows["trd.column"][1:5] == (2, None, 2, 1.0)
    assert rows["trd.panel"][3] == 0 and rows["TRD-BLK"][3] == 1
    assert rows[spantrace.OUTSIDE][3] == 2      # outside, and no launch


def test_launches_per_column_hold_the_sub_spans(root):
    rec = record(root, ops=OPS, trace=traced(), spans=[{}])
    # three kernels in the two columns (one in a sub-span; the copy not
    # counted)
    assert read(root, "trd_launches_per_col", rec) == pytest.approx(1.5)


def test_idle_is_put_down_to_the_span_open_when_it_ended():
    trace = spantrace.attribute(RANGES, OPS)
    idle = spantrace.idle_by_span(trace)
    # the gap 1.4 → 2.1 ends in the first column; 2.3 → 4.6 and 4.7 → 4.8
    # in the second; 5.0 → 7.6 in the update; 8.6 → 9.6 in TRD-BLK alone,
    # after the panel closed; 9.8 → 12.0 and 25.3 → 31.0 outside every
    # span; 12.5 → 22.0 in the level; 24.0 → 25.2 in the counters' span.
    # The panel, open through most of them, holds none: each goes to the
    # innermost span.
    assert idle["trd.column"] == pytest.approx(0.7 + 2.3 + 0.1)
    assert idle["trd.update"] == pytest.approx(2.6)
    assert idle["TRD-BLK"] == pytest.approx(1.0)
    assert idle[spantrace.OUTSIDE] == pytest.approx(2.2 + 5.7)
    assert idle["dc.level"] == pytest.approx(9.5)
    assert idle["dc.count"] == pytest.approx(1.2)
    assert "trd.panel" not in idle and "trd.column.form" not in idle


def test_stage_idle_and_host_microseconds(root):
    stages = [{"TRD-BLK": {"seconds": 4.0}, "D&C": {"seconds": 5.0}},
              {"TRD-BLK": {"seconds": 6.0}, "D&C": {"seconds": 5.0}}]
    host = [{"TRD-BLK": {"count": 1, "host_s": 0.010, "self_s": 0.002},
             "trd.column": {"count": 4, "host_s": 0.008, "self_s": 0.001}}]
    rec = record(root, ops=OPS, stages=stages, spans=host, trace=traced())
    # TRD-BLK: the union of 0.1 + 0.2 + 0.1 (copy) + 0.2 + 1.0 + 0.2
    assert read(root, "trd_blk_idle", rec) == pytest.approx(
        100 * (1 - 1.8 / 5.0))
    # D&C: the level's 2.0, the counters' kernel left out
    assert read(root, "dc_tree_idle", rec) == pytest.approx(
        100 * (1 - 2.0 / 5.0))
    # the window's 5.0 s of TRD-BLK, 80% of it in the four columns
    assert read(root, "trd_col_host_us", rec) == pytest.approx(
        1e6 * 5.0 * 0.8 / 4)
    # a stage the window's solves lack reads None
    rec = record(root, ops=OPS, stages=[{}, {}], spans=host, trace=traced())
    assert read(root, "trd_blk_idle", rec) is None
    assert read(root, "trd_col_host_us", rec) is None


def test_the_table_is_logged(root):
    host = {"trd.column": {"count": 2, "host_s": 0.004, "self_s": 0.001},
            "trd.column.form": {"count": 2, "host_s": 0.003,
                                "self_s": 0.003}}
    rec = record(root, ops=[(GEMV, 0.0, 1.0)], spans=[host],
                 trace=traced())
    lines = []
    spantrace.log_table(rec, lines.append)
    text = "\n".join(lines)
    assert "spans: trd.column | 2 | 500.0 | 2 | 1.0 |" in text
    assert "kernels 9, in dc.count 1, the rest 8 against the profiled " \
           "solve's 1; outside every span 2 (22.2" in text
    assert "trd.column host 0.004 s; its self and its sub-spans' self " \
           "times 0.004 s" in text
    assert "deflated share 0.25" in text


def test_the_harness_profiled_solve_opens_no_range(small_spec):
    """The solve of ``rec["ops"]`` runs with profile=True, which opens no
    ``record_function`` range: annotated ranges, which a CUDA trace would
    carry as device-side annotations, come only with Profiler(annotate=
    True)."""
    import torch

    from perfbench import gen

    spec = small_spec("eigen_s-f64-n8192.A-random", 96)
    solve, _ = harness.solver(spec, torch.device("cpu"))
    a = gen.make_matrix(spec["traffic"]["matrix"], 96, "float64", 7, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        info = solve(a, True)[2]
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events())
    assert info.spans["trd.column"]["count"] == 96


@pytest.mark.gpu
def test_device_ops_of_the_profiled_solve_hold_no_range(small_spec,
                                                        cuda_device):
    from perfbench import devtrace, gen

    spec = small_spec("eigen_s-f64-n8192.A-random", 256)
    solve, _ = harness.solver(spec, cuda_device)
    a = gen.make_matrix(spec["traffic"]["matrix"], 256, "float64", 7,
                        cuda_device)
    solve(a, True)
    ops, _ = devtrace.profile_ops(lambda: solve(a, True), cuda_device)
    info = solve(a, True)[2]
    assert ops and not {name for name, _, _ in ops} & set(info.spans)


def test_the_annotated_session_records_the_ranges_alone():
    """``profile_spans`` on the CPU: the spans of an annotated solve come
    back as ranges, one a span the solve's own fold counts, and the
    session records no torch op (no device operation on the CPU)."""
    import torch

    import eigenexa_tpu_torch as ex
    from eigenexa_tpu_torch.utils.profiler import Profiler

    a = torch.rand(80, 80, dtype=torch.float64)
    a = a + a.T
    ctx = ex.eigen_init("cpu")
    infos = []
    ranges, ops, _ = spantrace.profile_spans(
        lambda: infos.append(ex.eigen_s(a, ctx=ctx, profile=Profiler(
            annotate=True))[2]), "cpu")
    assert ops == []
    counts = {}
    for name, s, e in ranges:
        assert e >= s
        counts[name] = counts.get(name, 0) + 1
    assert counts == {k: v["count"] for k, v in infos[0].spans.items()}
    trace = spantrace.attribute(ranges, ops)
    assert spantrace.span_count(trace, "trd.column") == 80
