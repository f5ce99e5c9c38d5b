"""Benchmark entry of the PyTorch/CUDA port: a full symmetric eigensolve on
one CUDA card, the counterpart of ``bench.py``.

Prints ONE JSON line, with ``bench.py``'s keys:
  {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ..., "extra": ...}

``value`` is the best of three warm calls of the faster of ``eigen_sx`` and
``eigen_s`` whose checks all pass (the flagship), on the Frank matrix, whose
spectrum is known.  ``vs_baseline`` is the speedup over the incumbent,
``torch.linalg.eigh`` on the same matrix on the same card (best of three
warm calls, each closed by ``torch.cuda.synchronize``).  ``extra.times``
holds every timed call of each driver and of ``eigh``: the host's launch
rate moves a warm solve from call to call.

Each timed call is one line of the ported runner (``bench.runner.run_case``,
mode 1 on matrix type 0), which also takes its residual and orthogonality
(Z streamed in column blocks above n = 16384); ``eigh`` is the runner's
incumbent.  Each driver's untimed first call keeps its w and Z: they give
the eigenvalue errors and, for the flagship, the bitwise rerun.

Env knobs: BENCH_N (default 8192), BENCH_DTYPE (f32 or f64), BENCH_NB (64),
BENCH_LARGE (at n=8192 f32, n=16384 and n=32768 ``eigen_s`` each twice,
cold then warm; 0 turns them off).  Without a CUDA device it exits 1 and
solves nothing.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

DRIVERS = {"eigen_sx": 0, "eigen_s": 1}   # the runner's solver numbers
LARGE = (16384, 32768)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _model_flops(n: int) -> float:
    return (4.0 / 3.0 + 2.0) * n ** 3   # TRD + TRBAK models (ref counts)


def _driver(name: str):
    from eigenexa_tpu_torch import eigen_s, eigen_sx

    return {"eigen_sx": eigen_sx, "eigen_s": eigen_s}[name]


def _passed(report: dict, check: str) -> bool:
    return report["checks"][check]["status"] == "PASSED"


def _runs(name: str, n: int, dtype, ctx, repeats: int, keep_z: bool):
    """``name`` on Frank n: one untimed call of the driver, then `repeats`
    runner lines (timed, checked).  Returns the untimed call's w (and Z if
    `keep_z`; otherwise Z is freed before the runner's lines), its
    scaled eigenvalue check, its seconds, and the runner's reports."""
    from eigenexa_tpu_torch.bench.runner import BenchCase, run_case
    from eigenexa_tpu_torch.testing import (eigenvalue_check_scaled, frank,
                                            frank_spectrum)

    a = frank(n, dtype, ctx.device)
    w, z, info = _driver(name)(a, ctx=ctx)
    del a
    if not keep_z:
        z = None
    # w in the solve's dtype: the D&C returns f64 values for an f32 solve
    w_chk = eigenvalue_check_scaled(w.to(dtype), frank_spectrum(n))
    case = BenchCase(n=n, nvec=n, mode=1, mtype=0, solver=DRIVERS[name])
    reports = [run_case(case, ctx=ctx, dtype=dtype, printer=None)
               for _ in range(repeats)]
    return w, z, w_chk, info.elapsed, reports


def _eigh_times(a, repeats: int) -> list:
    """The runner's incumbent on `a`: one warm-up call, then `repeats`
    timed ones.  A refusal rises here: the headline needs the number."""
    from eigenexa_tpu_torch.bench.runner import _incumbent

    times = []
    for i in range(repeats + 1):
        rep = {}
        _incumbent(rep, a, printer=None)
        if "torch_eigh_s" not in rep:
            raise RuntimeError(f"torch.linalg.eigh: {rep['torch_eigh_error']}")
        if i:
            times.append(rep["torch_eigh_s"])
    return times


def _large(n: int, ctx) -> dict:
    """eigen_s on Frank n f32 twice: the cold call gives w's check, the
    warm one, a runner line, the time and the column-streamed checks."""
    w, _, w_chk, cold, (rep,) = _runs("eigen_s", n, torch.float32, ctx, 1,
                                      keep_z=False)
    del w
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t = rep["elapsed_s"]
    return {f"n{n}_time_s": round(t, 3),
            f"n{n}_times": [round(cold, 4), t],
            f"n{n}_model_gflops": round(_model_flops(n) / t / 1e9, 1),
            f"n{n}_residual": rep["checks"]["residual"]["value"],
            f"n{n}_orthogonality": rep["checks"]["orthogonality"]["value"],
            f"n{n}_w_err_scaled": w_chk.value,
            f"n{n}_pass": bool(_passed(rep, "residual")
                               and _passed(rep, "orthogonality")
                               and w_chk.passed)}


def measure(n: int, dtype, ctx, large=()) -> dict:
    """The benchmark's JSON object on ctx's device: both drivers on Frank
    n, ``eigh`` beside them, the flagship's checks and bitwise rerun, and
    ``eigen_s`` at each size of `large`."""
    from eigenexa_tpu_torch.testing import frank, frank_spectrum

    times, runs, passing = {}, {}, {}
    for name in DRIVERS:
        runs[name] = _runs(name, n, dtype, ctx, 3, keep_z=True)
        w, z, w_chk, _, reports = runs[name]
        times[name] = [r["elapsed_s"] for r in reports]
        passing[name] = (_passed(reports[-1], "residual")
                         and _passed(reports[-1], "orthogonality")
                         and w_chk.passed)
    best = {name: min(t) for name, t in times.items()}
    # the flagship: the faster driver whose checks all pass (the faster
    # overall if neither does; the checks are reported below either way)
    flagship = min([k for k in best if passing[k]] or list(best),
                   key=best.get)
    w, z, w_chk, _, reports = runs.pop(flagship)
    runs.clear()
    checks = reports[-1]["checks"]

    # the incumbent on the same card and matrix, the same barrier
    a = frank(n, dtype, ctx.device)
    times["torch_eigh"] = _eigh_times(a, 3)
    t_eigh, t_ours = min(times["torch_eigh"]), best[flagship]

    w_err = float(np.max(np.abs(np.sort(w.cpu().numpy())
                                - frank_spectrum(n).numpy())))
    # run-to-run bitwise reproducibility, compared on the device
    w2, z2, _ = _driver(flagship)(a, ctx=ctx)
    repro = bool(torch.equal(w, w2) and torch.equal(z, z2))
    del a, w, z, w2, z2
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    extra = {}
    for n_l in large:
        extra.update(_large(n_l, ctx))
    return {
        "metric": f"eigh_n{n}_{str(dtype).split('.')[-1]}_time",
        "value": round(t_ours, 4),
        "unit": "s",
        "vs_baseline": round(t_eigh / t_ours, 3),
        "extra": {
            "flagship": flagship,
            "eigen_s_s": round(best["eigen_s"], 4),
            "eigen_sx_s": round(best["eigen_sx"], 4),
            "torch_eigh_s": round(t_eigh, 4),
            "times": times,
            "model_gflops": round(_model_flops(n) / t_ours / 1e9, 1),
            "residual": round(checks["residual"]["value"], 4),
            "orthogonality": round(checks["orthogonality"]["value"], 4),
            "w_err_abs": float(f"{w_err:.3g}"),
            "w_err_scaled": round(w_chk.value, 4),
            "residual_pass": _passed(reports[-1], "residual"),
            "ortho_pass": _passed(reports[-1], "orthogonality"),
            "w_pass": bool(w_chk.passed),
            "repro_bitwise": repro,
            **extra,
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 1
    from eigenexa_tpu_torch import eigen_init
    from eigenexa_tpu_torch.runtime import SolverConfig

    n = int(os.environ.get("BENCH_N", "8192"))
    dtype = {"f32": torch.float32, "f64": torch.float64}[
        os.environ.get("BENCH_DTYPE", "f32")]
    nb = int(os.environ.get("BENCH_NB", "64"))
    gpu = _gpu_line()
    ctx = eigen_init(torch.device("cuda", 0),
                     SolverConfig(panel_forward=nb, panel_backward=128))
    large = (LARGE if n == 8192 and dtype == torch.float32
             and os.environ.get("BENCH_LARGE", "1") != "0" else ())
    result = measure(n, dtype, ctx, large)
    result["extra"]["device"] = gpu
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
