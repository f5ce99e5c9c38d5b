"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero with no
result line:

1. device  — a CUDA card is required (no CPU fallback); prints the
             ``nvidia-smi --query-gpu=name,power.limit`` line;
2. build   — builds the hand-written kernels from the checkout's sources;
3. kernels — ``sub_matmul`` through the CUDA kernel against its plain
             PyTorch version on the card, at the main path's shapes, a
             ragged shape and an in-place strided view, f32 and f64, with
             kernel and plain times (CUDA events, median);
4. slice   — ``eigen_s(frank(8192, float32))`` cold, warm and with the
             stage split; checks residual, orthogonality, the scaled
             eigenvalue error, the kernel launch count per solve and
             bitwise equality of the cold and warm results;
5. f64     — ``eigen_s(frank(2048, float64))``: residual and orthogonality
             PASS, the strict √ε eigenvalue check never a hard FAIL.

The line before the last is the kernels JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

N_SLICE = 8192
N_F64 = 2048
KERNEL_SOURCE = "eigenexa_tpu_torch/csrc/sub_matmul.cu"
KERNEL_REPLACES = "eigenexa_tpu/ops/pallas_kernels.py:99"
# error bound factor per dtype: only the summation order differs
ERR_C = {"float32": 1e-5, "float64": 1e-13}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def expected_launches(n: int, nb_f: int = 64, nb_b: int = 128) -> int:
    """sub_matmul launches of one eigen_s solve: one per TRD panel that
    has a trailing block, one per WY block of the back-transform."""
    trd = -(-(n - nb_f) // nb_f) if n > nb_f else 0
    return trd + -(-(n - 1) // nb_b)


def _time_ms(fn, device, reps: int = 10) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        fn()
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(n_main: int):
    """(label, m, n, k, view offset or None) at the main path's shapes:
    the first TRD trailing update (m = n = N − 64, k = 2·64) and a full WY
    block (m = n = N, k = 128); a ragged case; an in-place strided view."""
    return [
        ("rank2k", n_main - 64, n_main - 64, 128, None),
        ("wy", n_main, n_main, 128, None),
        ("ragged", 1000, 777, 100, None),
        ("inplace_view", 1063, 1063, 128, 37),
    ]


def kernel_phase(device, n_main: int, timed: bool):
    """Compare the kernel with its plain version; returns one result row
    per (case, dtype)."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    rows = []
    gen = torch.Generator(device=device).manual_seed(1234)
    for dtype in (torch.float32, torch.float64):
        for label, m, n, k, off in kernel_cases(n_main):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, dtype=dtype,
                                   device=device)

            p, q = rnd(m, k), rnd(n, k)
            if off is None:
                b = rnd(m, n)
                ref = kernels._sub_matmul_ref(b, p, q)
                out = kernels.sub_matmul(b, p, q)
                outside_ok = True
            else:
                big = rnd(m + off, n + off)
                before = big.clone()
                view = big[off:, off:]
                b = view.clone()
                ref = kernels._sub_matmul_ref(view, p, q)
                out = kernels.sub_matmul(view, p, q, out=view)
                if out.data_ptr() != view.data_ptr():
                    raise AssertionError("in-place call did not write B")
                outside_ok = (torch.equal(big[:off], before[:off])
                              and torch.equal(big[:, :off], before[:, :off]))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            err = float((out - ref).abs().max())
            bound = ERR_C[str(dtype).split(".")[1]] * (
                float(b.abs().max())
                + k * float(p.abs().max()) * float(q.abs().max()))
            row = {"case": label, "dtype": str(dtype).split(".")[1],
                   "m": m, "n": n, "k": k, "max_abs_err": err,
                   "bound": bound}
            if timed:
                o = torch.empty_like(b)
                row["ms"] = _time_ms(
                    lambda: kernels.sub_matmul(b, p, q, out=o), device)
                row["plain_ms"] = _time_ms(
                    lambda: kernels._sub_matmul_ref(b, p, q), device)
            print("kernel", json.dumps(row), flush=True)
            if not (err <= bound) or not outside_ok:
                raise AssertionError(f"sub_matmul disagrees with its plain "
                                     f"version: {row}, outside view "
                                     f"untouched: {outside_ok}")
            rows.append(row)
    return rows


def slice_phase(device, n: int):
    """eigen_s on Frank n (f32) three times; returns the kernel launches
    of the first solve."""
    import torch
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import (eigenvalue_check_scaled, frank,
                                            frank_spectrum,
                                            orthogonality_check,
                                            residual_check)

    a = frank(n, torch.float32, device)
    w_true = frank_spectrum(n, torch.float64)
    per_solve = expected_launches(n)
    counts = []
    kernels.LAUNCHES["sub_matmul"] = 0
    w1, z1, cold = eigen_s(a)
    counts.append(kernels.LAUNCHES["sub_matmul"])
    w2, z2, warm = eigen_s(a)
    counts.append(kernels.LAUNCHES["sub_matmul"] - counts[0])
    w3, z3, prof = eigen_s(a, profile=True)
    counts.append(kernels.LAUNCHES["sub_matmul"] - sum(counts))
    print(f"slice: Frank n={n} f32 eigen_s cold {cold.elapsed:.4f} s, warm "
          f"{warm.elapsed:.4f} s = {warm.gflops:.2f} GFLOP/s (flop_model "
          f"{warm.flops:.6g}), profiled {prof.elapsed:.4f} s", flush=True)
    prof.stage_report(lambda s: print("slice stage" + s, flush=True))
    print(f"slice: sub_matmul launches per solve {counts} (expected "
          f"{per_solve})", flush=True)
    if counts != [per_solve] * 3:
        raise AssertionError(f"launch counts {counts} != {per_solve}")

    if w2.shape != (n,) or z2.shape != (n, n) or z2.dtype != torch.float32:
        raise AssertionError(f"bad output shapes/dtypes {w2.shape} "
                             f"{z2.shape} {z2.dtype}")
    if not bool(torch.isfinite(w2).all() & torch.isfinite(z2).all()):
        raise AssertionError("non-finite eigenpairs")
    res = residual_check(a, z2, w2)
    orth = orthogonality_check(z2)
    wsc = eigenvalue_check_scaled(w2.to(torch.float32), w_true)
    repro = bool(torch.equal(w1, w2) and torch.equal(z1, z2))
    repro_prof = bool(torch.equal(w1, w3) and torch.equal(z1, z3))
    print(f"slice checks: {res} {orth} {wsc} bitwise cold==warm {repro} "
          f"cold==profiled {repro_prof}", flush=True)
    if not (res.passed and orth.passed and wsc.passed and repro):
        raise AssertionError("slice checks failed")
    return counts[0]


def f64_phase(device, n: int):
    import torch
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import (eigenvalue_check, frank,
                                            frank_spectrum,
                                            orthogonality_check,
                                            residual_check)

    a = frank(n, torch.float64, device)
    before = kernels.LAUNCHES["sub_matmul"]
    w, z, info = eigen_s(a)
    launches = kernels.LAUNCHES["sub_matmul"] - before
    res = residual_check(a, z, w)
    orth = orthogonality_check(z)
    wt = eigenvalue_check(w, frank_spectrum(n, torch.float64, device))
    print(f"f64: Frank n={n} eigen_s {info.elapsed:.4f} s, launches "
          f"{launches}: {res} {orth} {wt}", flush=True)
    if launches != expected_launches(n):
        raise AssertionError(f"f64 launches {launches}")
    if not (res.passed and orth.passed and (wt.passed or wt.caution)):
        raise AssertionError("f64 checks failed")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from eigenexa_tpu_torch import eigen_init
    from eigenexa_tpu_torch.ops import _build

    eigen_init(device)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds} s)", flush=True)

    rows = kernel_phase(device, N_SLICE, timed=True)
    launches = slice_phase(device, N_SLICE)
    f64_phase(device, N_F64)

    main_row = rows[0]  # rank-2k trailing update, f32, main-path shape
    print(json.dumps({"kernels": [{
        "name": "sub_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"]}]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
