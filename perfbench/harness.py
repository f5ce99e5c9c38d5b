"""One run of one cell: set-up, the measured window, the traced solve and
the check that decides ``correct``.

The window is a closed loop of one caller, as an SCF loop calls: the
cell's routine solves the one seeded matrix back to back until
``--seconds`` have passed, and the last solve started runs to its end.
Each solve ends in ``torch.cuda.synchronize``.  Every solve's eigenvalues,
and its eigenvectors at k columns drawn from the seed, are kept on the
device; the last solve's outputs are kept whole.  Once the window has
closed, the reference (``reference.py``) judges them all.

With ``--trace 1`` every solve of the window runs with ``profile=True``
(the program's stage regions, a barrier a stage), and one more solve runs
under ``torch.profiler`` after the window.  Every metric is a reader of
its own in ``metrics/<name>.py``; :func:`run_cell` hands each the record
of the run (see ``metrics/__init__.py``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from perfbench import devtrace, gen, reference

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "eigenexa_tpu"})
SAMPLE_COLS = 64        # eigenpairs of every window solve judged
# the modes the reference judges: all eigenpairs (A), eigenvalues only (N)
CHECKED_MODES = ("A", "N")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> dict:
    """Everything the cell ``name`` of ``root/BENCHMARK.json`` needs, found
    by its names: the configuration's file, ``perfbench/traffic/<mix>.json``
    and ``perfbench/limits/<cell>.json``, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / "perfbench"
    return {
        "name": name,
        "cell": cell,
        "config": json.loads(
            (root / configs[cell["config"]]["file"]).read_text()),
        "traffic": json.loads(
            (here / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((here / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
        "metrics_dir": here / "metrics",
    }


def reader(metrics_dir: Path, name: str):
    """``read`` of ``metrics_dir/<name>.py``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, metrics_dir: Path, rec: dict) -> dict:
    """{name: {value, unit}} of every entry whose reader found something."""
    out = {}
    for m in entries:
        value = reader(metrics_dir, m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(names=None) -> list:
    """Top-level names among the loaded modules (or ``names``) that the
    benchmark may not load, each compared whole."""
    return sorted({m.split(".")[0] for m in (names or sys.modules)}
                  & FORBIDDEN)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def devices_used(device) -> int:
    """The CUDA devices on which the run allocated memory (1 on the
    CPU)."""
    import torch

    if device.type != "cuda":
        return 1
    return sum(torch.cuda.max_memory_allocated(i) > 0
               for i in range(torch.cuda.device_count()))


def judge(spec: dict, a, w_keep, z_keep, cols, w_last, z_last) -> dict:
    """The numbers that decide ``correct``, each with its limit, and the
    solves whose own numbers pass a limit.  ``w_keep``: every solve's
    eigenvalues; ``z_keep``: their eigenvectors at ``cols`` (None in mode
    N); ``w_last``, ``z_last``: the last solve's whole outputs."""
    import torch

    limits = spec["limits"]
    eps = torch.finfo(gen.DTYPES[spec["config"]["dtype"]]).eps
    t0 = time.perf_counter()
    w_ref = reference.spectrum(a, vectors=z_last is not None)
    _sync(a.device)
    log(f"incumbent: torch.linalg.{'eigh' if z_last is not None else 'eigvalsh'}"
        f" on the cell's matrix {time.perf_counter() - t0} s (first call "
        "in the process)")

    def over(name, value):
        return not value <= limits[name]["limit"]   # NaN is over

    per_solve = {"w_gap": [reference.w_gap(w, w_ref, eps) for w in w_keep]}
    if z_keep is not None:
        per_solve["residual_sampled"] = [
            reference.residual_sampled(a, zs, w[cols], eps)
            for w, zs in zip(w_keep, z_keep)]
    failed = sum(any(over(k, v[i]) for k, v in per_solve.items())
                 for i in range(len(w_keep)))
    values = {k: math.nan if any(x != x for x in v) else max(v)
              for k, v in per_solve.items()}
    if z_last is not None:
        values["residual"] = reference.residual(a, z_last, w_last, eps)
        values["orthogonality"] = reference.orthogonality(z_last, eps)
    checks = {k: {"value": v, "limit": limits[k]["limit"]}
              for k, v in values.items()}
    return {"checks": checks, "failed": failed,
            "correct": not any(over(k, v) for k, v in values.items())}


def solver(spec: dict, device):
    """(solve(a, profile), the program's kernel module) for the cell's
    routine, mode and configuration on ``device``."""
    import eigenexa_tpu_torch as ex
    from eigenexa_tpu_torch.ops import householder, kernels

    cfg, traffic = spec["config"], spec["traffic"]
    householder.TRD_IMPL = cfg.get("reduction", "auto")
    ctx = ex.eigen_init(device, ex.SolverConfig(
        panel_forward=int(cfg["panel_forward"]),
        panel_backward=int(cfg["panel_backward"])))
    drive = getattr(ex, cfg["routine"])
    n, mode = int(cfg["n"]), traffic["mode"]

    def solve(a, profile):
        return drive(a, nvec=n, mode=mode, ctx=ctx, profile=profile)

    return solve, kernels


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    import torch

    cfg, traffic = spec["config"], spec["traffic"]
    n, dtype = int(cfg["n"]), cfg["dtype"]
    if traffic["mode"] not in CHECKED_MODES:
        raise ValueError(f"no check for mode {traffic['mode']!r}")
    vectors = traffic["mode"] == "A"
    solve, kernels = solver(spec, device)
    a = gen.make_matrix(traffic["matrix"], n, dtype, seed, device)

    # set-up: one warm solve of the cell's own routine, mode and shapes
    t0 = time.perf_counter()
    w, z, _ = solve(a, trace)
    del w, z
    warm_s = time.perf_counter() - t0
    k = min(SAMPLE_COLS, n)
    cols = torch.randperm(n, generator=gen.generator(seed, "cpu"))[:k]
    cols = cols.sort().values.to(device)
    cap = int(4 * seconds / max(warm_s, 1e-3)) + 4
    w_keep = torch.empty((cap, n), dtype=torch.float64, device=device)
    z_keep = (torch.empty((cap, n, k), dtype=a.dtype, device=device)
              if vectors else None)
    _sync(device)
    cuda = device.type == "cuda"
    base = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s} s, warm solve {warm_s} s")

    walls, stages = [], []
    t_w0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        w, z, info = solve(a, trace)
        _sync(device)
        t_end = time.perf_counter()
        i = len(walls)
        walls.append(t_end - t)
        stages.append(info.stages)
        w_keep[i].copy_(w)
        if vectors:
            z_keep[i].copy_(z.index_select(1, cols))
        if t_end - t_w0 >= seconds or i + 1 == cap:
            break
        del w, z, info
    _sync(device)
    window_s = t_end - t_w0
    peak_total = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {window_s} s, {len(walls)} solves: {walls}")

    rec = {"config": cfg, "traffic": traffic, "n": n, "dtype": dtype, "setup_s": setup_s, "window_s": window_s,
           "walls": walls,
           "solves": len(walls), "stages": stages,
           "peak_bytes": peak_total - base, "ops": [], "launches": {},
           "profiled_wall_s": None}
    if trace and cuda:
        before = dict(kernels.LAUNCHES)
        ops, wall = devtrace.profile_ops(lambda: solve(a, True), device)
        rec.update(ops=ops, profiled_wall_s=wall,
                   launches={k: kernels.LAUNCHES[k] - before[k]
                             for k in before})
        log(f"profiled solve {wall} s, {len(ops)} device operations")

    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(spec[kind], spec["metrics_dir"], rec)

    # the check, once the window has closed and the program's input is
    # gone: the benchmark's input again, from the seed
    w_last, z_last = w, (z if vectors else None)
    del a, w, z, info
    a = gen.make_matrix(traffic["matrix"], n, dtype, seed, device)
    count = len(walls)
    verdict = judge(spec, a, w_keep[:count],
                    z_keep[:count] if vectors else None, cols, w_last, z_last)

    result = {"correct": verdict["correct"], "attempted": count,
              "failed": verdict["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": devices_used(device),
                         "memory_peak_bytes": peak_total}}
    if trace and rec["ops"]:
        result["device"]["busy_s"] = devtrace.busy_s(rec["ops"])
        result["device"]["window_s"] = rec["profiled_wall_s"]
        result["breakdown"] = devtrace.breakdown(rec["ops"])
    result["checks"] = verdict["checks"]
    return result


def _log_card() -> None:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        log(f"card: {smi.stdout.strip()}")
    except (OSError, subprocess.TimeoutExpired) as err:
        log(f"card: nvidia-smi not read ({err})")


def main(argv, t_start: float, root: Path) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_cell(args.workload, root)

    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    _log_card()
    device = torch.device("cuda:0")
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      device, t_start)
    found = forbidden_modules()
    if found:
        log(f"no result: the process loaded {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
