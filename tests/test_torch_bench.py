"""The port's benchmark layer (eigenexa_tpu_torch/bench/runner.py,
bench_torch.py, utils/profiler.py) on the CPU, the counterpart of
tests/test_bench_runner.py: the input-line parser field by field against
the JAX package's, ``run_case`` over every solver and the modes the input
files use (n = 64, the GEV line n = 96), each report held to the
reference's PASS statuses, two reports against the JAX runner's (keys,
configuration and every check's status), ``run_input_file``, the
profiler's table, and the no-card rules of both entry points.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import eigenexa_tpu_torch.runtime as truntime  # noqa: E402
from eigenexa_tpu_torch.bench import runner  # noqa: E402
from eigenexa_tpu_torch.bench.runner import (BenchCase, main,  # noqa: E402
                                             run_case, run_input_file)
from eigenexa_tpu_torch.testing import CheckResult  # noqa: E402
from eigenexa_tpu_torch.utils import profiler  # noqa: E402
from eigenexa_tpu_torch.utils.profiler import Profiler  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _restore_default_context():
    """run_case installs its context as the port's default; put the one
    that was there back."""
    saved = truntime._DEFAULT_CTX
    yield
    truntime._DEFAULT_CTX = saved


@pytest.mark.parametrize("line", [
    "! comment", "", "# comment", " 128 64 32 64 2 4 0 ", " 0 0 0 0 0 0 0",
    "-5 1 1 1 1 1 1", " 256", " 300 0 0 0 6 7", " 96 96 64 128 1 2 3 9"])
def test_parse_matches_jax(line):
    import dataclasses

    from eigenexa_tpu.bench.runner import BenchCase as JaxCase

    mine, ref = BenchCase.parse(line), JaxCase.parse(line)
    assert (mine is None) == (ref is None)
    if ref is not None:
        assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    if line.strip() == "128 64 32 64 2 4 0":
        assert (mine.n, mine.nvec, mine.bx, mine.by, mine.mode, mine.mtype,
                mine.solver) == (128, 64, 32, 64, 2, 4, 0)


# (case, dtype, the checks the report must hold, PASSED unless named with
# another status, its stages under profile)
LINES = {
    "eigen_s": (BenchCase(n=64, nvec=64, mode=1, mtype=0, solver=1),
                torch.float64, ("residual", "orthogonality", "eigenvalues"),
                ["TRD-BLK", "D&C", "TRDBAK"]),
    "eigen_sx_designed": (BenchCase(n=64, nvec=64, mode=1, mtype=4,
                                    solver=0), torch.float64,
                          ("residual", "orthogonality", "eigenvalues"),
                          ["PRD-BLK", "D&C", "TRDBAK"]),
    "mode_n": (BenchCase(n=64, nvec=64, mode=0, mtype=0), torch.float64,
               ("eigenvalues",), ["TRD-BLK", "BISECT"]),
    # eigenvalues CAUTION: sin³ puts eigenvalues near 0, where the
    # check's relative error reads 1e-5 (the JAX runner's status too)
    "mode_x_sin3": (BenchCase(n=64, nvec=64, mode=2, mtype=5),
                    torch.float64, ("residual", "orthogonality",
                                    ("eigenvalues", "CAUTION")), None),
    "mode_r_eigen_sx": (BenchCase(n=64, nvec=64, mode=6, solver=0),
                        torch.float64, ("orthogonality",), None),
    "mode_r_eigen_s": (BenchCase(n=64, nvec=64, mode=6, solver=1),
                       torch.float32, ("orthogonality",), None),
    "eigen_h_f64": (BenchCase(n=64, nvec=64, mode=1, solver=2),
                    torch.float64, ("residual", "orthogonality",
                                    "eigenvalues"), None),
    "eigen_s_f32": (BenchCase(n=64, nvec=32, mode=1, mtype=1),
                    torch.float32, ("residual", "orthogonality"), None),
    "gev_a": (BenchCase(n=96, nvec=96, mode=1, mtype=2, solver=3),
              torch.float64, ("gev_residual", "b_orthogonality"),
              ["SOLVE-B", "REDUCE", "SOLVE-A'", "BACK"]),
    "gev_n": (BenchCase(n=96, nvec=96, mode=0, mtype=2, solver=3),
              torch.float32, (), None),
}


@pytest.mark.parametrize("name", list(LINES))
def test_run_case_passes(name):
    case, dtype, checks, stages = LINES[name]
    rep = run_case(case, dtype=dtype, device=CPU, printer=None,
                   profile=stages is not None)
    want = dict(c if isinstance(c, tuple) else (c, "PASSED")
                for c in checks)
    assert {k: c["status"] for k, c in rep["checks"].items()} == want, rep
    assert not rep["hard_fail"]
    assert rep["n"] == case.n and rep["grid"] == "1x1"
    assert rep["dtype"] == str(dtype).split(".")[-1]
    if stages is not None:
        assert list(rep["stages"]) == stages
    else:
        assert "stages" not in rep


@pytest.mark.parametrize("case", [
    BenchCase(n=64, nvec=64, mode=1, mtype=0, solver=1),
    BenchCase(n=96, nvec=96, mode=1, mtype=2, solver=3)],
    ids=["eigen_s", "eigen_gev"])
def test_report_matches_the_jax_runner(case):
    """The same keys, configuration fields and status of every check as
    the JAX runner's report of the same line (f64, on one device)."""
    import jax
    import jax.numpy as jnp

    import eigenexa_tpu as ex
    from eigenexa_tpu.bench.runner import run_case as jax_run_case
    from eigenexa_tpu.parallel.mesh import build_mesh

    one = ex.eigen_init(mesh=build_mesh(devices=jax.devices()[:1]))
    ref = jax_run_case(case, ctx=one, dtype=jnp.float64, printer=None)
    rep = run_case(case, dtype=torch.float64, device=CPU, printer=None)
    assert set(rep) == set(ref)
    for key in ("n", "nvec", "mode", "matrix", "solver", "dtype", "grid",
                "comm_s", "hard_fail"):
        assert rep[key] == ref[key], key
    assert ({k: v["status"] for k, v in rep["checks"].items()}
            == {k: v["status"] for k, v in ref["checks"].items()})


def _small_input(tmp_path, n: int = 64) -> Path:
    """benchmarks/IN with every N cut to n."""
    lines = []
    for line in (REPO / "benchmarks" / "IN").read_text().splitlines():
        parts = line.split()
        if parts and not line.lstrip().startswith("!") and int(parts[0]) > 0:
            line = " ".join([str(n)] + [str(min(int(parts[1]), n))]
                            + parts[2:])
        lines.append(line)
    path = tmp_path / "IN"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_run_input_file(tmp_path):
    reports = run_input_file(str(_small_input(tmp_path)), device=CPU,
                             printer=None)
    assert [(r["solver"], r["mode"], r["matrix"]) for r in reports] == [
        ("eigen_s", "A", "Frank"), ("eigen_s", "A", "RandomSymmetric"),
        ("eigen_s", "X", "DesignedLinear"), ("eigen_sx", "A", "Frank"),
        ("eigen_s", "N", "Frank")]
    assert not any(r["hard_fail"] for r in reports)
    assert all(r["checks"][k]["status"] == "PASSED" for r in reports
               for k in ("residual", "orthogonality") if k in r["checks"])


def test_a_hard_failure_stops_the_input_file(tmp_path, monkeypatch):
    """A check that fails hard ends the loop with SystemExit after its
    report was printed (the reference's MPI_Abort)."""
    monkeypatch.setattr(runner, "orthogonality_check",
                        lambda z, nvec=None, col_chunk=0: CheckResult(
                            "orthogonality", 99.0, False, True))
    lines = []
    with pytest.raises(SystemExit, match="hard accuracy failure"):
        run_input_file(str(_small_input(tmp_path)), device=CPU,
                       printer=lines.append)
    assert sum(line.startswith("---") for line in lines) == 1
    assert any("FAILED (hard)" in line for line in lines)


def test_profiler_report_counts_and_global_region():
    p = Profiler()
    for _ in range(2):
        with p.region("a", flops=100.0, device=CPU):
            sum(range(1000))
    p.add("b", 0.5)
    lines = []
    rows = p.report(printer=lines.append)
    assert rows["a"]["count"] == 2 and rows["a"]["seconds"] > 0
    assert "gflops" in rows["a"] and "gflops" not in rows["b"]
    assert rows["b"] == {"seconds": 0.5, "count": 1}
    assert len(lines) == 3 and lines[0].startswith("region")
    assert list(p.stages()) == ["a", "b"]
    p.reset()
    assert p.report(printer=None) == {} and p.stages() == {}
    off = Profiler(enabled=False)
    with off.region("x", device=CPU):
        pass
    assert off.times == {} and off.counts == {} and off.records == []
    # spans report to the active profiler alone, and only while it is
    # active; a region opens a span of its own name
    with profiler.span("outside"):
        pass
    with profiler.active(p):
        with p.region("c", device=CPU):
            with profiler.span("inside"):
                pass
    with profiler.span("outside"):
        pass
    assert list(p.spans()) == ["c", "inside"]
    assert [r[:2] for r in p.records] == [["c", -1], ["inside", 0]]
    assert p.spans()["inside"]["count"] == 1
    assert p.spans()["c"]["self_s"] <= p.spans()["c"]["host_s"]
    assert profiler._ACTIVE is None
    # every region names its device, so none on a card goes unsynced
    with pytest.raises(TypeError, match="device"):
        p.region("a")


REFUSAL = ("cusolver error: CUSOLVER_STATUS_INVALID_VALUE, when calling "
           "`cusolverDnXsyevd_bufferSize( handle, params, jobz, uplo, n, "
           "CUDA_R_32F, ...)`")


@pytest.mark.parametrize("error, recorded", [
    (RuntimeError(REFUSAL), True),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 4 GiB"),
     False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False)])
def test_incumbent_records_only_cusolvers_refusal(monkeypatch, error,
                                                   recorded):
    """The workspace query's refusal is recorded beside the line; an
    out-of-memory or any other error of the incumbent rises."""
    def eigh(a):
        raise error

    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    report = {}
    a = torch.eye(4, dtype=torch.float64)
    if recorded:
        runner._incumbent(report, a, printer=None)
        assert report == {"torch_eigh_error": REFUSAL[:200]}
    else:
        with pytest.raises(type(error)):
            runner._incumbent(report, a, printer=None)
        assert report == {}


@pytest.mark.parametrize("argv", [["-x", "2", "2"], ["-g", "2"]])
def test_distributed_flags_name_a17(argv, capsys):
    """-x and -g (ROADMAP A17) run the distributed drivers over gloo ranks
    on the CPU: rank 0's report, with -x its COMM_STAT block."""
    assert main(argv + ["-n", "64", "--device", "cpu", "--f64",
                        "--backend", "gloo", "--timeout", "120"]) == 0
    out = capsys.readouterr().out
    if argv[0] == "-x":
        assert "--- eigen_s (distributed)  N=64" in out and "grid=2x2" in out
        assert "COMM_STAT" in out and "  total    count" in out
        assert "*** residual        *** : PASSED" in out
        assert "*** orthogonality   *** : PASSED" in out
    else:
        assert "--- independent x2  N=64 grid=1x2" in out
        assert out.count("residual: PASSED  orthogonality: PASSED") == 2


def test_eigen_sx_line_under_x_runs_distributed_eigen_sx(capsys):
    """An eigen_sx line under -x (ROADMAP A17b) runs distributed_eigen_sx
    on gloo ranks on the CPU (f32): rank 0's report with its checks and the
    COMM_STAT block."""
    assert main(["-x", "2", "2", "--solver", "0", "-n", "64", "--device",
                 "cpu", "--backend", "gloo", "--timeout", "120"]) == 0
    out = capsys.readouterr().out
    assert "--- eigen_sx (distributed)  N=64" in out and "grid=2x2" in out
    assert "dtype=float32" in out
    assert "COMM_STAT" in out and "  total    count" in out
    assert "*** residual        *** : PASSED" in out
    assert "*** orthogonality   *** : PASSED" in out


def test_distributed_flags_keep_the_backend_rule():
    # nccl, the default, needs a card a rank: no quiet switch to gloo
    with pytest.raises(ValueError, match="gloo"):
        main(["-x", "2", "2", "-n", "64", "--device", "cpu"])


def test_main_runs_on_the_cpu_only_when_asked(capsys):
    assert main(["-n", "48", "--device", "cpu", "--f64", "--eigh"]) == 0
    out = capsys.readouterr().out
    assert "--- eigen_s  N=48" in out and "torch.linalg.eigh" in out
    assert main(["-L"]) == 0
    assert "DesignedFile" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the default device is the card: no quiet move to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            main(["-n", "48"])


def _python(code_or_file, env_extra=None, args=()):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.run([sys.executable, *code_or_file, *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_bench_torch_refuses_without_a_card():
    proc = _python([str(REPO / "bench_torch.py")],
                   {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert not any(line.lstrip().startswith("{")
                   for line in proc.stdout.splitlines())
    assert "no CUDA device" in proc.stderr


def _bench_torch():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_torch", REPO / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_torch_measures_on_the_cpu():
    """bench_torch.py's JSON object, built on the runner, on a CPU context
    at n = 64 f64 with one large extra at n = 48 (f32): bench.py's keys,
    three timed calls of each driver and of eigh, every flag true."""
    import json

    bt = _bench_torch()
    ctx = truntime.eigen_init(CPU)
    res = bt.measure(64, torch.float64, ctx, large=(48,))
    json.dumps(res)
    assert res["metric"] == "eigh_n64_float64_time" and res["unit"] == "s"
    ex = res["extra"]
    assert set(ex["times"]) == {"eigen_sx", "eigen_s", "torch_eigh"}
    assert all(len(t) == 3 for t in ex["times"].values())
    assert res["value"] == min(ex["times"][ex["flagship"]])
    assert ex["torch_eigh_s"] == min(ex["times"]["torch_eigh"])
    for flag in ("residual_pass", "ortho_pass", "w_pass", "repro_bitwise",
                 "n48_pass"):
        assert ex[flag] is True, flag
    assert ex["w_err_abs"] < 1e-10 and len(ex["n48_times"]) == 2
    assert {"residual", "orthogonality", "w_err_scaled", "model_gflops",
            "eigen_s_s", "eigen_sx_s", "n48_time_s", "n48_residual",
            "n48_orthogonality", "n48_w_err_scaled",
            "n48_model_gflops"} <= set(ex)


def test_bench_layer_imports_no_jax():
    code = ("import sys\n"
            "import eigenexa_tpu_torch.bench.runner, bench_torch\n"
            "assert 'jax' not in sys.modules, 'jax'\n"
            "assert not any(m.split('.')[0] == 'eigenexa_tpu' "
            "for m in sys.modules)\n")
    proc = _python(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_checks_stream_large_lines(monkeypatch):
    """Above CHUNK_ABOVE the checks take Z in blocks of CHECK_CHUNK
    columns; the values agree with the whole products."""
    seen = []
    real = runner.residual_check

    def spy(a, z, w, nvec=None, col_chunk=0):
        seen.append(col_chunk)
        return real(a, z, w, nvec, col_chunk)

    monkeypatch.setattr(runner, "residual_check", spy)
    case = BenchCase(n=80, nvec=80)
    whole = run_case(case, dtype=torch.float64, device=CPU, printer=None)
    monkeypatch.setattr(runner, "CHUNK_ABOVE", 64)
    monkeypatch.setattr(runner, "CHECK_CHUNK", 32)
    streamed = run_case(case, dtype=torch.float64, device=CPU, printer=None)
    assert seen == [0, 32]
    for name in ("residual", "orthogonality"):
        assert np.isclose(whole["checks"][name]["value"],
                          streamed["checks"][name]["value"], rtol=1e-12)


def test_chip_smoke_bench_runner_phase_passes_on_the_cpu():
    """The card script's bench phase, its runner half, on CPU tensors:
    benchmarks/IN and IN_GEV at f32 and f64 (n = 256), every residual and
    orthogonality PASS, no kernel launched."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    counts = cs.bench_runner_phase(torch.device("cpu"))
    assert counts == dict.fromkeys(counts, 0) and "sturm_bisect" in counts
