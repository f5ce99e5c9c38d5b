"""The port's spans and counters (``eigenexa_tpu_torch/utils/profiler.py``)
on the CPU: the no-op path of an unprofiled solve, the fold of nested
spans into counts, host and self times, the D&C's counters on a merge with
planted deflation, and the drivers' spans at n ≈ 200 with their outputs
bit for bit those of an unprofiled solve.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.ops import secular  # noqa: E402
from eigenexa_tpu_torch.utils import profiler  # noqa: E402
from eigenexa_tpu_torch.utils.profiler import Profiler  # noqa: E402

CPU = torch.device("cpu")
NB = 64


@pytest.fixture
def ctx():
    c = ext.eigen_init("cpu", config=ext.SolverConfig(panel_forward=NB,
                                                      panel_backward=128))
    yield c
    ext.eigen_free(c)


def _sym(n, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, n, dtype=dtype, generator=g)
    if a.is_complex():
        return a + a.conj().T
    return a + a.T


def _fake_clock(monkeypatch, step=10):
    """The profiler's clock as a counter that moves ``step`` ns a read."""
    ticks = iter(range(step, 10 ** 9, step))
    monkeypatch.setattr(profiler, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks),
        perf_counter=profiler.time.perf_counter))


def columns(n, nb=NB):
    """The columns the reduction factors: whole panels while more than nb
    rows are live, then the remainder's columns where it has two or more."""
    k = 0
    while n - k > nb:
        k += nb
    return k + (n - k if n - k > 1 else 0)


def pairs(n, nb=NB):
    """The reflector pairs of the band-2 reduction: nb/2 a panel while
    more than nb + 2 rows are live, then the remainder padded to an even
    size of at least m + 2."""
    k = 0
    while n - k > nb + 2:
        k += nb
    m = n - k
    return k // 2 + (-(-(m + 2) // 2) if m else 0)


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    assert profiler._ACTIVE is None
    monkeypatch.setattr(profiler, "time", None)     # no clock is read
    monkeypatch.setattr(profiler, "_Span", None)    # no span is made
    assert profiler.span("a") is profiler.span("b") is profiler._NULL
    assert not profiler.annotating()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("trd.column"):
            with profiler.span("trd.column.form"):
                pass
        profiler.count("dc.coords", object())   # never added: no op at all
    assert list(prof.profiler.kineto_results.events()) == []
    # an inactive Profiler leaves the module as it was
    with profiler.active(Profiler(enabled=False)):
        assert profiler._ACTIVE is None
    with profiler.active(None):
        assert profiler.span("c") is profiler._NULL


def test_spans_nest_and_fold_into_counts_host_and_self_times(monkeypatch):
    _fake_clock(monkeypatch)
    p = Profiler()
    with profiler.active(p):
        with profiler.span("a"):
            with profiler.span("b"):
                pass
            with profiler.span("b"):
                with profiler.span("c"):
                    pass
                with profiler.span("c"):
                    pass
        profiler.count("k", 2)
        profiler.count("k", torch.tensor(3))
    assert profiler._ACTIVE is None
    names = [r[0] for r in p.records]
    parents = [r[1] for r in p.records]
    assert names == ["a", "b", "b", "c", "c"]
    assert parents == [-1, 0, 0, 2, 2]
    ns = {i: r[3] - r[2] for i, r in enumerate(p.records)}
    spans = p.spans()
    assert list(spans) == ["a", "b", "c"]
    assert [spans[k]["count"] for k in spans] == [1, 2, 2]
    assert spans["a"]["host_s"] == pytest.approx(ns[0] * 1e-9)
    assert spans["a"]["self_s"] == pytest.approx((ns[0] - ns[1] - ns[2])
                                                 * 1e-9)
    assert spans["b"]["host_s"] == pytest.approx((ns[1] + ns[2]) * 1e-9)
    assert spans["b"]["self_s"] == pytest.approx(
        (ns[1] + ns[2] - ns[3] - ns[4]) * 1e-9)
    assert spans["c"]["self_s"] == spans["c"]["host_s"]
    assert all(row["self_s"] > 0 for row in spans.values())
    assert p.read_counters() == {"k": 5}
    # a region opens a span of its own name around the others
    q = Profiler()
    with profiler.active(q):
        with q.region("TRD-BLK", device=CPU):
            with profiler.span("trd.panel"):
                pass
    assert [r[:2] for r in q.records] == [["TRD-BLK", -1], ["trd.panel", 0]]
    assert list(q.stages()) == ["TRD-BLK"]


def test_an_annotating_profiler_opens_a_range_for_every_span():
    p = Profiler(annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.active(p):
            assert profiler.annotating()
            with profiler.span("x"):
                with profiler.span("y"):
                    pass
    ranges = [e.name() for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    assert sorted(ranges) == ["x", "y"]
    assert list(p.spans()) == ["x", "y"]


def _planted_merge():
    """Two merges of m = 8 with known deflation: in the first, a run of
    three equal d (two coordinates deflate into its leader) and one zero z
    (it deflates); in the second, nothing deflates."""
    d = torch.tensor([[0.0, 1.0, 1.0, 1.0, 2.0, 3.0, 4.0, 5.0],
                      [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]],
                     dtype=torch.float64)
    z = torch.tensor([[0.5, 0.5, 0.5, 0.5, 0.0, 0.5, 0.5, 0.5],
                      [0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]],
                     dtype=torch.float64)
    rho = torch.tensor([1.0, 1.0], dtype=torch.float64)
    return d, z, rho


@pytest.mark.parametrize("form", ["core", "apply_parts"])
def test_merge_counters_with_planted_deflation(form):
    d, z, rho = _planted_merge()
    eye = torch.eye(8, dtype=torch.float64).expand(2, 8, 8)

    def merge():
        if form == "core":
            return secular.rank1_merge_core(d, z, rho).lam
        return secular.rank1_merge_apply_parts(d, z, rho, ((eye, 0),),
                                               panel=4)[0]

    plain = merge()
    quiet = Profiler()
    with profiler.active(quiet):
        assert torch.equal(merge(), plain)
    assert quiet.read_counters() == {} and "dc.count" not in quiet.spans()
    p = Profiler(annotate=True)
    with profiler.active(p):
        assert torch.equal(merge(), plain)
    assert p.read_counters() == {"dc.coords": 16, "dc.deflated": 3,
                                 "dc.on_pole": 0}
    assert p.spans()["dc.count"]["count"] == 1


def _spans_of(drive, a, ctx, **kw):
    w0, z0, info0 = drive(a, ctx=ctx, **kw)
    w1, z1, info1 = drive(a, ctx=ctx, profile=True, **kw)
    w2, z2, info2 = drive(a, ctx=ctx, profile=Profiler(annotate=True), **kw)
    for w, z in ((w1, z1), (w2, z2)):
        assert torch.equal(w, w0)
        assert z is z0 is None or torch.equal(z, z0)
    assert info0.spans == {} and info0.counters == {}
    assert [k for k in info2.spans if k != "dc.count"] == list(info1.spans)
    for name, row in info1.spans.items():
        assert info2.spans[name]["count"] == row["count"]
        assert 0 <= row["self_s"] <= row["host_s"]
    return info1, info2


@pytest.mark.parametrize("impl", ["rolled", "windowed"])
def test_eigen_s_spans_a_column_each_and_keeps_its_bits(ctx, monkeypatch,
                                                        impl):
    monkeypatch.setattr(th, "TRD_IMPL", impl)
    n = 200
    info, annotated = _spans_of(ext.eigen_s, _sym(n), ctx)
    spans = info.spans
    assert spans["trd.column"]["count"] == columns(n)
    for part in ("form", "reflector", "matvec", "w"):
        assert spans[f"trd.column.{part}"]["count"] == columns(n)
    assert spans["trd.panel"]["count"] == -(-columns(n) // NB)
    assert spans["trd.update"]["count"] == n // NB - (n % NB == 0)
    assert spans["TRD-BLK"]["count"] == spans["D&C"]["count"] == 1
    assert spans["dc.level"]["count"] == spans["dc.secular"]["count"] == 3
    assert spans["trbak.block"]["count"] == 2
    # the column's self time and its sub-spans' self times make its host
    # time
    parts = spans["trd.column"]["self_s"] + sum(
        spans[f"trd.column.{p}"]["self_s"]
        for p in ("form", "reflector", "matvec", "w"))
    assert parts == pytest.approx(spans["trd.column"]["host_s"])
    counters = annotated.counters
    assert counters["dc.coords"] == 3 * 256      # three levels, m = 256
    assert 0 <= counters["dc.on_pole"] <= counters["dc.coords"]
    assert 56 <= counters["dc.deflated"] < counters["dc.coords"]


@pytest.mark.parametrize("impl", ["rolled", "windowed"])
def test_eigen_sx_spans_a_pair_each_and_keeps_its_bits(ctx, monkeypatch,
                                                       impl):
    monkeypatch.setattr(th, "TRD_IMPL", impl)
    n = 200
    info, annotated = _spans_of(ext.eigen_sx, _sym(n), ctx)
    spans = info.spans
    assert spans["prd.pair"]["count"] == pairs(n)
    for part in ("form", "reflector", "matvec", "w"):
        assert spans[f"prd.pair.{part}"]["count"] == pairs(n)
    # the pair's self time and its sub-spans' self times make its host time
    parts = spans["prd.pair"]["self_s"] + sum(
        spans[f"prd.pair.{p}"]["self_s"]
        for p in ("form", "reflector", "matvec", "w"))
    assert parts == pytest.approx(spans["prd.pair"]["host_s"])
    assert "PRD-BLK" in spans and "trd.column" not in spans
    assert spans["prd.update"]["count"] == 3     # panels at 0, 64, 128
    assert spans["dc.secular"]["count"] == 2 * spans["dc.level"]["count"]
    # the band-2 merges count their coordinates too: two merges a join,
    # three levels of m = 256
    counters = annotated.counters
    assert counters["dc.coords"] == 2 * 3 * 256
    assert 0 <= counters["dc.on_pole"] <= counters["dc.coords"]
    assert 0 <= counters["dc.deflated"] < counters["dc.coords"]


def test_eigen_h_spans_a_column_each_and_keeps_its_bits(ctx):
    n = 130
    info, _ = _spans_of(ext.eigen_h, _sym(n, torch.complex128), ctx)
    assert info.spans["trd.column"]["count"] == columns(n)
    assert info.spans["TRDBAK"]["count"] == 1


def test_eigen_gev_spans_both_inner_solves(ctx):
    n = 96
    b = _sym(n, seed=1) + 2 * n * torch.eye(n, dtype=torch.float64)
    w0, z0, _ = ext.eigen_gev(_sym(n), b, ctx=ctx)
    w, z, info = ext.eigen_gev(_sym(n), b, ctx=ctx, profile=True)
    assert torch.equal(w, w0) and torch.equal(z, z0)
    assert info.spans["trd.column"]["count"] == 2 * columns(n)
    assert list(info.stages) == ["SOLVE-B", "REDUCE", "SOLVE-A'", "BACK"]


def test_a_profiled_solve_makes_the_ops_of_an_unprofiled_one(ctx):
    """profile=True (no annotation) adds no torch op and no range: the
    device trace of a profiled solve holds the kernels of a plain one."""
    a = _sym(100)

    def ops(profile):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ext.eigen_s(a, ctx=ctx, profile=profile)
        events = list(prof.profiler.kineto_results.events())
        assert not any(e.is_user_annotation() for e in events)
        names = {}
        for e in events:
            names[e.name()] = names.get(e.name(), 0) + 1
        return names

    assert ops(True) == ops(False)
