"""The cell ``eigen_sx-f64-n8192.A-random``: its files found by name, its
readers (``prd_blk_s``, ``prd_pair_host_us``, ``prd_launches_per_pair``,
``prd_blk_idle``, ``dc_band_s``, ``pair_reflectors_roofline``,
``pair_update_roofline``) on records written out by hand, and one run of
the cell on the CPU at a small n, judged by the cell's own limits."""

import time

import pytest
import torch

from perfbench import harness, spantrace

CELL = "eigen_sx-f64-n8192.A-random"
READERS = ("prd_blk_s", "prd_pair_host_us", "prd_launches_per_pair",
           "prd_blk_idle", "dc_band_s", "pair_reflectors_roofline",
           "pair_update_roofline")
SPAN_READERS = ("prd_pair_host_us", "prd_launches_per_pair", "prd_blk_idle")
GEMV = "void gemv2T_kernel_val<int, int, double>(double const*)"
COPY = "Memcpy DtoD (Device -> Device)"

# PRD-BLK [0, 10] holds a panel [0.5, 9] with two pairs, each with its
# reflector's sub-span, and the update; D&C [20, 30] a level with a
# counters' span
RANGES = [("PRD-BLK", 0.0, 10.0), ("prd.panel", 0.5, 9.0),
          ("prd.pair", 1.0, 3.0), ("prd.pair.reflector", 1.1, 1.5),
          ("prd.pair", 4.0, 6.0), ("prd.pair.reflector", 4.1, 4.4),
          ("prd.update", 7.0, 8.0), ("D&C", 20.0, 30.0),
          ("dc.level", 21.0, 29.0), ("dc.count", 25.0, 26.0)]
# launched in the first pair's reflector, in the first pair, a copy and a
# kernel in the second pair's reflector, in the update, in the level, in
# the counters' span
OPS = [(GEMV, 1.3, 1.4, 1.2), (GEMV, 2.1, 2.3, 2.0), (COPY, 4.2, 4.3, 4.15),
       (GEMV, 4.8, 5.0, 4.2), (GEMV, 7.6, 8.6, 7.5), (GEMV, 22.0, 24.0, 21.5),
       (GEMV, 25.2, 25.3, 25.1)]


def record(root, ops=(), stages=None, spans=None, trace=None):
    spec = harness.load_cell(CELL, root)
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
                 counters={})
    return trace


def test_the_cell_resolves_to_its_files(root):
    spec = harness.load_cell(CELL, root)
    cfg = spec["config"]
    assert (cfg["routine"], cfg["dtype"], cfg["n"]) == ("eigen_sx", "float64",
                                                        8192)
    assert list(cfg["reduced"]) == ["n"]
    assert spec["traffic"]["mode"] == "A"
    assert spec["traffic"]["matrix"] == {"kind": "random_symmetric"}
    assert spec["cell"]["chips"] == 1
    assert set(spec["limits"]) == {"w_gap", "residual", "residual_sampled",
                                   "orthogonality"}
    assert spec["limits"]["residual"]["limit"] == 768.0
    assert spec["limits"]["orthogonality"]["limit"] == 8.0
    lim = spec["limits"]["w_gap"]
    assert lim["lower"] < lim["limit"] < lim["upper"]
    assert {m["name"] for m in spec["end_to_end"]} == {
        "solve_s", "peak_mem_gib", "setup_s"}
    # the cell's own readers, and the device metrics without a list; none
    # of eigen_s's stage or sub_matmul readers
    assert {m["name"] for m in spec["per_layer"]} == set(READERS) | {
        "kernels_per_solve", "device_idle"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(spec["metrics_dir"], m["name"]))


def test_nothing_to_read_gives_none(root, monkeypatch):
    # no stage regions (an untraced run) and no device trace (the CPU)
    rec = record(root)
    for name in READERS:
        assert read(root, name, rec) is None
    # a program without spans gives None before any solve
    from eigenexa_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "span")
    rec = record(root, ops=[(GEMV, 0.0, 1.0)])
    for name in SPAN_READERS:
        assert read(root, name, rec) is None
    # a trace without the pair's spans
    rec = record(root, ops=[(GEMV, 0.0, 1.0)], spans=[{}],
                 trace={"spans": [], "ops": [(GEMV, 0.0, 1.0, -1)]})
    for name in SPAN_READERS:
        assert read(root, name, rec) is None


def test_the_readers_on_a_recorded_run(root):
    stages = [{"PRD-BLK": {"seconds": 4.0}, "D&C": {"seconds": 1.0}},
              {"PRD-BLK": {"seconds": 6.0}, "D&C": {"seconds": 2.0}}]
    host = [{"PRD-BLK": {"count": 1, "host_s": 0.010, "self_s": 0.002},
             "prd.pair": {"count": 4, "host_s": 0.006, "self_s": 0.001}}]
    rec = record(root, ops=OPS, stages=stages, spans=host, trace=traced())
    assert read(root, "prd_blk_s", rec) == pytest.approx(5.0)
    assert read(root, "dc_band_s", rec) == pytest.approx(1.5)
    # the window's 5.0 s of PRD-BLK, 60% of it in the four pairs
    assert read(root, "prd_pair_host_us", rec) == pytest.approx(
        1e6 * 5.0 * 0.6 / 4)
    # three kernels in the two pairs (two in a sub-span; the copy not
    # counted)
    assert read(root, "prd_launches_per_pair", rec) == pytest.approx(1.5)
    # PRD-BLK: the union of 0.1 + 0.2 + 0.1 (copy) + 0.2 + 1.0 over 5.0 s
    assert read(root, "prd_blk_idle", rec) == pytest.approx(
        100 * (1 - 1.6 / 5.0))
    # a stage the window's solves lack reads None
    rec = record(root, ops=OPS, stages=[{}, {}], spans=host, trace=traced())
    for name in ("prd_blk_s", "dc_band_s", "prd_pair_host_us",
                 "prd_blk_idle"):
        assert read(root, name, rec) is None


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu(root, small_spec, trace):
    """The cell through ``harness.run_cell`` at n = 64 on the CPU, with a
    seed past 32 bits, judged by the cell's own limits.  Traced, the stage
    regions give the two stage readers; the span readers find no device
    trace on the CPU and are left out of the line."""
    spec = small_spec(CELL, 64)
    out = harness.run_cell(spec, 3_000_000_019_123, 0.05, trace,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(spec["limits"])
    if trace:
        assert set(out["metrics"]) == {"prd_blk_s", "dc_band_s"}
    else:
        assert set(out["metrics"]) == {"solve_s", "setup_s"}


PAIR = ("void (anonymous namespace)::pair_reflectors_kernel<(anonymous "
        "namespace)::F64>(int, int, double const*, long long, double*, "
        "long long, double*, double*)")


def test_the_pair_roofline_on_a_recorded_run(root):
    """The pair kernel's share: its 4,096 launches at n = 8192 (127 panels
    of 32 pairs on the live block, then 32 on the remainder's 64 rows
    padded to 66), each bound by its bytes, over the kernel's device time;
    a parent without the kernel reads None, and a launch count the
    enumeration does not give fails the run."""
    from perfbench.peaks import bound_s

    rec = record(root, ops=[(GEMV, 0.0, 1.0)])
    assert read(root, "pair_reflectors_roofline", rec) is None
    ops = [(PAIR, 2e-5 * i, 2e-5 * i + 1e-5) for i in range(4096)]
    rec = record(root, ops=ops + [(GEMV, 0.0, 1.0)])
    rec["launches"] = {"pair_reflectors": 4096, "sub_matmul": 191}
    shapes = [(8192 - k, c0 + 2) for k in range(0, 8128, 64)
              for c0 in range(0, 64, 2)] + [(66, c0 + 2)
                                            for c0 in range(0, 64, 2)]
    elements = [2 * (m - p) + 2 * m + 6 for m, p in shapes]
    want = sum(bound_s("float64", e, 30 * (m - p))
               for e, (m, p) in zip(elements, shapes))
    assert want == pytest.approx(sum(elements) * 8 / 3.35e12)
    assert read(root, "pair_reflectors_roofline", rec) == pytest.approx(
        100 * want / (4096 * 1e-5))
    rec["launches"]["pair_reflectors"] = 4097
    with pytest.raises(RuntimeError, match="4096 launches enumerated"):
        read(root, "pair_reflectors_roofline", rec)


UPDATE = ("void (anonymous namespace)::pair_update_rows<(anonymous "
          "namespace)::F64>(int, int, int, int, double const*, long long, "
          "double const*, double*, long long, double const*, long long, "
          "double const*, double const*, double*)")


def test_the_update_roofline_on_a_recorded_run(root):
    """The update kernels' share: its 4,097 calls at n = 8192 (127
    panels of 32 pairs on the live block, then the remainder's 33 pairs on
    its 64 rows padded to 66), each pair with its c0 earlier columns, over
    the kernel's device time; a parent without the kernel reads None, and
    a launch count the enumeration does not give fails the run."""
    from perfbench.peaks import bound_s

    rec = record(root, ops=[(GEMV, 0.0, 1.0)])
    assert read(root, "pair_update_roofline", rec) is None
    ops = [(UPDATE, 2e-5 * i, 2e-5 * i + 1e-5) for i in range(4097)]
    rec = record(root, ops=ops + [(PAIR, 0.0, 1e-5)])
    rec["launches"] = {"pair_update": 4097, "pair_reflectors": 4096}
    shapes = [(8192 - k, c0) for k in range(0, 8128, 64)
              for c0 in range(0, 64, 2)] + [(66, c0) for c0 in range(0, 66, 2)]
    want = sum(bound_s("float64", 2 * m * c0 + 8 * m + 4,
                       16 * m * c0 + 20 * m) for m, c0 in shapes)
    assert want == pytest.approx(sum(2 * m * c0 + 8 * m + 4
                                     for m, c0 in shapes) * 8 / 3.35e12)
    assert read(root, "pair_update_roofline", rec) == pytest.approx(
        100 * want / (4097 * 1e-5))
    rec["launches"]["pair_update"] = 4096
    with pytest.raises(RuntimeError, match="4097 launches enumerated"):
        read(root, "pair_update_roofline", rec)
