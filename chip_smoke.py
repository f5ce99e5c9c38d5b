"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero with no
result line:

1. device   — a CUDA card is required (no CPU fallback);
2. build    — builds the hand-written kernels from the checkout's sources
              (``csrc/sub_matmul.cu``, ``csrc/symv_lower.cu``);
3. kernels  — each kernel through its wrapper against its plain PyTorch
              version on the card, f32 and f64, one ``kernel`` line per
              case with the error and its bound, the kernel's and the plain
              version's time (CUDA events, median), the time of the one
              library call that computes the same (``library_ms``) and the
              least time the card could take (``bound_ms``):
              ``sub_matmul`` at the main paths' shapes, a ragged shape and
              an in-place strided view; ``symv_lower`` on a matrix whose
              upper triangle holds garbage (zeros above the window, two
              calls bitwise equal); ``rank2k_update_window`` (everything
              outside the window bitwise untouched);
4. slice    — the rolled path: ``eigen_s(frank(8192, float32))`` cold, warm
              and with the stage split; checks residual, orthogonality, the
              scaled eigenvalue error, the kernel launch counts per solve
              and bitwise equality of the cold and warm results;
5. f64      — ``eigen_s(frank(2048, float64))``: residual and orthogonality
              PASS, the strict √ε eigenvalue check never a hard FAIL;
6. windowed — the windowed reduction forced (``householder.TRD_IMPL``):
              ``eigen_s(frank(16384, float32))`` cold, then warm with the
              stage split and the peak device memory; the same checks, and
              launch counts per solve of all three kernels.

Every path is driven with the launch counts set to 0 just before it and
read just after.  The last three lines are the kernels JSON object, the
``nvidia-smi --query-gpu=name,power.limit`` line, and
``{"ok": true, "device": {...}}``.

Two more modes take findings, check nothing, and print no result line:

``python3 chip_smoke.py --findings`` runs, after the build, ``compare``
(the reduction alone, ``mode="C"``, at n = 8192, rolled and windowed in
turns, and ``tridiagonalize`` alone on a donated working matrix) and
``memory`` (the whole-solve peak device memory of both reductions at
n = 8192 and 16384).

``python3 chip_smoke.py --trd-profile N`` profiles one reduction of each
implementation at Frank n = N with ``torch.profiler`` and prints the
device-busy time, the idle share and the leading kernels.
"""

import json
import statistics
import subprocess
import sys
import time

N_SLICE = 8192
N_F64 = 2048
N_WINDOWED = 16384
NB_F = 64     # SolverConfig.panel_forward
NB_B = 128    # SolverConfig.panel_backward
KERNELS = {
    "sub_matmul": {
        "source": "eigenexa_tpu_torch/csrc/sub_matmul.cu",
        "replaces": "eigenexa_tpu/ops/pallas_kernels.py:99"},
    "symv_lower": {
        "source": "eigenexa_tpu_torch/csrc/symv_lower.cu",
        "replaces": "eigenexa_tpu/ops/pallas_kernels.py:211"},
    "rank2k_update_window": {
        "source": "eigenexa_tpu_torch/csrc/sub_matmul.cu",
        "replaces": "eigenexa_tpu/ops/pallas_kernels.py:335"},
}
# error bound factor per dtype: only the summation order differs
ERR_C = {"float32": 1e-5, "float64": 1e-13}
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the best rate the card has for exact arithmetic of each type, whether
# or not the kernels reach for it: FP32 on the CUDA cores (TF32 is a lower
# precision), FP64 on the FP64 Tensor Cores (DMMA)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def expected_launches(n: int, nb_f: int = NB_F, nb_b: int = NB_B) -> int:
    """sub_matmul launches of one rolled eigen_s solve: one per TRD panel
    that has a trailing block, one per WY block of the back-transform."""
    return _full_panels(n, nb_f) + -(-(n - 1) // nb_b)


def _full_panels(n: int, nb_f: int) -> int:
    """Panels of the reduction that are followed by a trailing update."""
    return -(-(n - nb_f) // nb_f) if n > nb_f else 0


def expected_launches_windowed(n: int, nb_f: int = NB_F,
                               nb_b: int = NB_B) -> dict:
    """Launches of one eigen_s solve through the windowed reduction: one
    symv_lower per column of every full panel, one rank2k_update_window
    per full panel, one sub_matmul per WY block of the back-transform."""
    panels = _full_panels(n, nb_f)
    return {"symv_lower": panels * nb_f, "rank2k_update_window": panels,
            "sub_matmul": -(-(n - 1) // nb_b)}


def _reset_launches(kernels) -> None:
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0


def _take_launches(kernels) -> dict:
    """Read the counts of the path just driven, and set them to 0."""
    counts = dict(kernels.LAUNCHES)
    _reset_launches(kernels)
    return counts


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


def _bound(dtype: str, elements: float, flops: float) -> dict:
    """The least time the card could take: each input element read once
    and each output element written once at the memory rate, or the
    operations at the peak rate of their type, whichever is larger."""
    t_bytes = elements * ITEMSIZE[dtype] / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def _name(dtype) -> str:
    return str(dtype).split(".")[1]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem_mark(device) -> int:
    """Bytes resident now; the peak is counted from here."""
    import torch

    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _mem_peak(device, resident: int) -> int:
    """Peak bytes since `_mem_mark`, above what was resident then."""
    import torch

    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device) - resident


def _timed_phase(name: str, fn, *args):
    """Run one phase and print the wall seconds it held the machine."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _report(row: dict, ok: bool, what: str) -> dict:
    print("kernel", json.dumps(row), flush=True)
    if not ok:
        raise AssertionError(f"{row['name']} {what}: {row}")
    return row


def kernel_cases(n_main: int, n_win: int):
    """(label, m, n, k, view offset or None) at the main paths' shapes:
    the first rolled TRD trailing update (m = n = N − 64, k = 2·64), a
    full WY block of the rolled path (m = n = N, k = 128) and of the
    windowed path's size; a ragged case; an in-place strided view."""
    return [
        ("rank2k", n_main - 64, n_main - 64, 128, None),
        ("wy", n_main, n_main, 128, None),
        ("wy_windowed_path", n_win, n_win, 128, None),
        ("ragged", 1000, 777, 100, None),
        ("inplace_view", 1063, 1063, 128, 37),
    ]


def kernel_phase(device, n_main: int, timed: bool, n_win: int = N_WINDOWED):
    """Compare sub_matmul with its plain version; returns one result row
    per (case, dtype)."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    rows = []
    gen = torch.Generator(device=device).manual_seed(1234)
    for dtype in (torch.float32, torch.float64):
        for label, m, n, k, off in kernel_cases(n_main, n_win):
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
            _sync(device)
            err = float((out - ref).abs().max())
            del out, ref
            bound = ERR_C[_name(dtype)] * (
                float(b.abs().max())
                + k * float(p.abs().max()) * float(q.abs().max()))
            row = {"name": "sub_matmul", "case": label,
                   "dtype": _name(dtype), "m": m, "n": n, "k": k,
                   "max_abs_err": err, "bound": bound}
            if timed:
                o = torch.empty_like(b)
                row["ms"] = _time_ms(
                    lambda: kernels.sub_matmul(b, p, q, out=o), device)
                row["plain_ms"] = _time_ms(
                    lambda: kernels._sub_matmul_ref(b, p, q), device)
                row["library_ms"] = _time_ms(
                    lambda: torch.addmm(b, p, q.T, alpha=-1, out=o), device)
                row.update(_bound(_name(dtype), 2 * m * n + (m + n) * k,
                                  2.0 * m * n * k))
                del o
            rows.append(_report(row, err <= bound and outside_ok,
                                f"disagrees with its plain version (outside "
                                f"view untouched: {outside_ok})"))
    return rows


def symv_cases(m_main: int):
    """(label, m, t0, nc): the first column of the windowed path (the full
    matrix), a window further down, the two-vector pass, a ragged size."""
    return [("first_column", m_main, 0, 1), ("window", m_main, 16, 1),
            ("pair", m_main, 0, 2), ("ragged", 1837, 1, 1)]


def symv_phase(device, m_main: int, timed: bool):
    """Compare symv_lower with its plain version on a matrix whose upper
    triangle is garbage; returns one result row per (case, dtype)."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    rows = []
    gen = torch.Generator(device=device).manual_seed(4321)
    for dtype in (torch.float32, torch.float64):
        for label, m, t0, nc in symv_cases(m_main):
            w0 = t0 * kernels.WIN_TM
            if w0 >= m:
                raise AssertionError(f"case {label}: window outside m={m}")
            b = torch.randn(m, m, generator=gen, dtype=dtype, device=device)
            # lower triangle: the symmetric matrix; upper: garbage
            b.triu_(1).mul_(1e6).add_(torch.randn(
                m, m, generator=gen, dtype=dtype, device=device).tril_())
            x = torch.randn(*((m,) if nc == 1 else (m, nc)), generator=gen,
                            dtype=dtype, device=device)
            ref = kernels._symv_lower_ref(b, x, t0)
            out = kernels.symv_lower(b, x, t0=t0)
            again = kernels.symv_lower(b, x, t0=t0)
            _sync(device)
            err = float((out - ref).abs().max())
            low_max = float(torch.tril(b[w0:, w0:]).abs().max())
            # a sum of m products in another order: the rounding grows
            # like sqrt(m), and a tile counted twice or dropped is O(1)
            bound = (ERR_C[_name(dtype)] * m ** 0.5 * low_max
                     * float(x.abs().max()))
            zeros_above = not bool(out[:w0].any())
            repeats = bool(torch.equal(out, again))
            del ref, again
            mw = m - w0
            row = {"name": "symv_lower", "case": label,
                   "dtype": _name(dtype), "m": m, "t0": t0, "nc": nc,
                   "max_abs_err": err, "bound": bound,
                   "zeros_above_window": zeros_above,
                   "bitwise_repeat": repeats}
            if timed:
                row["ms"] = _time_ms(
                    lambda: kernels.symv_lower(b, x, t0=t0), device)
                row["plain_ms"] = _time_ms(
                    lambda: kernels._symv_lower_ref(b, x, t0), device, 3)
                win, xw = b[w0:, w0:], x[w0:]
                row["library_ms"] = _time_ms(
                    (lambda: torch.mv(win, xw)) if nc == 1
                    else (lambda: torch.matmul(win, xw)), device)
                row.update(_bound(_name(dtype),
                                  mw * (mw + 1) / 2 + 2 * m * nc,
                                  2.0 * mw * mw * nc))
            rows.append(_report(
                row, err <= bound and zeros_above and repeats,
                "disagrees with its plain version, is not zero above the "
                "window or does not repeat bitwise"))
    return rows


def rank2k_window_cases(m_main: int):
    """(label, m, t0): the first panel of the windowed path, a window
    further down, a ragged size; k = 2·64."""
    return [("first_panel", m_main, 0), ("window", m_main, 8),
            ("ragged", 1837, 1)]


def rank2k_window_phase(device, m_main: int, timed: bool):
    """Compare rank2k_update_window with its plain version; returns one
    result row per (case, dtype)."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    rows = []
    nb = NB_F
    gen = torch.Generator(device=device).manual_seed(2143)
    for dtype in (torch.float32, torch.float64):
        for label, m, t0 in rank2k_window_cases(m_main):
            w0 = t0 * kernels.WIN_TM
            if w0 >= m:
                raise AssertionError(f"case {label}: window outside m={m}")

            def rnd(*shape):
                return torch.randn(*shape, generator=gen, dtype=dtype,
                                   device=device)

            b, u, w = rnd(m, m), rnd(m, nb), rnd(m, nb)
            bound = ERR_C[_name(dtype)] * (
                float(b.abs().max())
                + 2 * nb * float(u.abs().max()) * float(w.abs().max()))
            keep = b.clone()
            out = kernels.rank2k_update_window(b, u, w, t0=t0)
            if out is not b:
                raise AssertionError("rank2k_update_window did not return B")
            _sync(device)
            outside_ok = (torch.equal(b[:w0], keep[:w0])
                          and torch.equal(b[:, :w0], keep[:, :w0]))
            ref = kernels._rank2k_window_ref(keep, u, w, t0)  # keep is spent
            err = float((b[w0:, w0:] - ref[w0:, w0:]).abs().max())
            del ref, keep
            mw = m - w0
            row = {"name": "rank2k_update_window", "case": label,
                   "dtype": _name(dtype), "m": m, "t0": t0, "k": 2 * nb,
                   "max_abs_err": err, "bound": bound,
                   "outside_untouched": outside_ok}
            if timed:
                # timed in place: eleven updates of N(0,1) data stay finite
                row["ms"] = _time_ms(
                    lambda: kernels.rank2k_update_window(b, u, w, t0=t0),
                    device)
                row["plain_ms"] = _time_ms(
                    lambda: kernels._rank2k_window_ref(b, u, w, t0), device)
                p = torch.cat([u, w], dim=1)[w0:]
                qt = torch.cat([w, u], dim=1)[w0:].T
                win = b[w0:, w0:]
                row["library_ms"] = _time_ms(
                    lambda: win.addmm_(p, qt, alpha=-1), device)
                row.update(_bound(_name(dtype),
                                  2 * mw * mw + 2 * mw * 2 * nb,
                                  2.0 * mw * mw * 2 * nb))
            rows.append(_report(
                row, err <= bound and outside_ok,
                "disagrees with its plain version or wrote outside its "
                "window"))
    return rows


def _check_solution(label, a, w, z, w_true, others):
    """Shapes, finiteness, the reference's three checks, and bitwise
    equality with the solves in `others` ({name: (w, z)})."""
    import torch
    from eigenexa_tpu_torch.testing import (eigenvalue_check_scaled,
                                            orthogonality_check,
                                            residual_check)

    n = a.shape[0]
    if w.shape != (n,) or z.shape != (n, n) or z.dtype != a.dtype:
        raise AssertionError(f"bad output shapes/dtypes {w.shape} "
                             f"{z.shape} {z.dtype}")
    if not bool(torch.isfinite(w).all() & torch.isfinite(z).all()):
        raise AssertionError("non-finite eigenpairs")
    res = residual_check(a, z, w)
    orth = orthogonality_check(z)
    wsc = eigenvalue_check_scaled(w.to(a.dtype), w_true)
    same = {name: bool(torch.equal(w, wo) and torch.equal(z, zo))
            for name, (wo, zo) in others.items()}
    print(f"{label} checks: {res} {orth} {wsc} bitwise equal to "
          f"{same}", flush=True)
    if not (res.passed and orth.passed and wsc.passed):
        raise AssertionError(f"{label} checks failed")
    return same


def slice_phase(device, n: int):
    """The rolled path: eigen_s on Frank n (f32) three times; returns the
    kernel launches of the first solve and the warm solve's peak device
    memory above what was resident before it."""
    import torch
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import frank, frank_spectrum

    a = frank(n, torch.float32, device)
    w_true = frank_spectrum(n, torch.float64)
    want = {"sub_matmul": expected_launches(n), "symv_lower": 0,
            "rank2k_update_window": 0}
    counts = []
    _reset_launches(kernels)
    w1, z1, cold = eigen_s(a)
    counts.append(_take_launches(kernels))
    resident = _mem_mark(device)
    w2, z2, warm = eigen_s(a)
    peak = _mem_peak(device, resident)
    counts.append(_take_launches(kernels))
    w3, z3, prof = eigen_s(a, profile=True)
    counts.append(_take_launches(kernels))
    print(f"slice: Frank n={n} f32 eigen_s cold {cold.elapsed:.4f} s, warm "
          f"{warm.elapsed:.4f} s = {warm.gflops:.2f} GFLOP/s (flop_model "
          f"{warm.flops:.6g}), profiled {prof.elapsed:.4f} s", flush=True)
    prof.stage_report(lambda s: print("slice stage" + s, flush=True))
    print(f"slice: launches per solve {counts} (expected {want})",
          flush=True)
    if counts != [want] * 3:
        raise AssertionError(f"launch counts {counts} != {want}")
    same = _check_solution("slice", a, w2, z2, w_true,
                           {"cold": (w1, z1), "profiled": (w3, z3)})
    if not same["cold"]:
        raise AssertionError("slice: cold and warm solves differ")
    return counts[0], peak


def f64_phase(device, n: int):
    import torch
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import (eigenvalue_check, frank,
                                            frank_spectrum,
                                            orthogonality_check,
                                            residual_check)

    a = frank(n, torch.float64, device)
    _reset_launches(kernels)
    w, z, info = eigen_s(a)
    launches = _take_launches(kernels)["sub_matmul"]
    res = residual_check(a, z, w)
    orth = orthogonality_check(z)
    wt = eigenvalue_check(w, frank_spectrum(n, torch.float64, device))
    print(f"f64: Frank n={n} eigen_s {info.elapsed:.4f} s, launches "
          f"{launches}: {res} {orth} {wt}", flush=True)
    if launches != expected_launches(n):
        raise AssertionError(f"f64 launches {launches}")
    if not (res.passed and orth.passed and (wt.passed or wt.caution)):
        raise AssertionError("f64 checks failed")


def windowed_phase(device, n: int):
    """The windowed path: eigen_s on Frank n (f32) with the windowed
    reduction forced, cold and then warm with the stage split; returns the
    kernel launches of the first solve and the warm solve's peak device
    memory above what was resident before it."""
    import torch
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import householder, kernels
    from eigenexa_tpu_torch.testing import frank, frank_spectrum

    a = frank(n, torch.float32, device)
    w_true = frank_spectrum(n, torch.float64)
    want = expected_launches_windowed(n)
    old = householder.TRD_IMPL
    householder.TRD_IMPL = "windowed"
    try:
        _reset_launches(kernels)
        w1, z1, cold = eigen_s(a)
        counts = [_take_launches(kernels)]
        resident = _mem_mark(device)
        w2, z2, warm = eigen_s(a, profile=True)
        counts.append(_take_launches(kernels))
        peak = _mem_peak(device, resident)
    finally:
        householder.TRD_IMPL = old
    print(f"windowed: Frank n={n} f32 eigen_s cold {cold.elapsed:.4f} s, "
          f"warm (profiled) {warm.elapsed:.4f} s = {warm.gflops:.2f} "
          f"GFLOP/s (flop_model {warm.flops:.6g})", flush=True)
    warm.stage_report(lambda s: print("windowed stage" + s, flush=True))
    print(f"windowed: peak device memory of the warm solve above what was "
          f"resident before it (A, and the cold solve's w and Z): {peak} "
          f"bytes; resident {resident} bytes", flush=True)
    print(f"windowed: launches per solve {counts} (expected {want})",
          flush=True)
    if counts != [want] * 2:
        raise AssertionError(f"launch counts {counts} != {want}")
    same = _check_solution("windowed", a, w2, z2, w_true,
                           {"cold": (w1, z1)})
    if not same["cold"]:
        raise AssertionError("windowed: cold and warm solves differ")
    return counts[0], peak


def _solve_with(device, a, impl: str, mode: str) -> dict:
    """One profiled eigen_s with the reduction forced to `impl`: seconds,
    the TRD-BLK stage, and the peak device memory above what was resident
    before it (the input included in what was resident)."""
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import householder

    old = householder.TRD_IMPL
    householder.TRD_IMPL = impl
    try:
        resident = _mem_mark(device)
        w, _, info = eigen_s(a, mode=mode, profile=True)
        peak = _mem_peak(device, resident)
    finally:
        householder.TRD_IMPL = old
    return {"elapsed_s": info.elapsed,
            "trd_blk_s": info.stages["TRD-BLK"]["seconds"],
            "peak_bytes_above_resident": peak, "w_sum": float(w.sum())}


def compare_phase(device, n: int):
    """The reduction alone (mode C) through both implementations, in turns
    rolled, windowed, windowed, rolled; printed side by side."""
    import torch
    from eigenexa_tpu_torch.testing import frank

    a = frank(n, torch.float32, device)
    out = {}
    for impl in ("rolled", "windowed", "windowed", "rolled"):
        out.setdefault(impl, []).append(_solve_with(device, a, impl, "C"))
    print(f"compare: Frank n={n} f32 eigen_s mode C, in turns rolled, "
          f"windowed, windowed, rolled: {json.dumps(out)}", flush=True)
    # mode C builds its identity Z while the reflectors are alive, which
    # hides the reduction's own footprint: measure tridiagonalize alone on
    # a donated working matrix
    from eigenexa_tpu_torch.ops import householder

    alone = {}
    for impl in ("rolled", "windowed"):
        work = a.clone()
        resident = _mem_mark(device)
        t0 = time.perf_counter()
        trd = householder.tridiagonalize(work, nb=NB_F, impl=impl,
                                         donate=True)
        _sync(device)
        alone[impl] = {
            "seconds": time.perf_counter() - t0,
            "peak_bytes_above_working_matrix": _mem_peak(device, resident),
            "v_is_working_matrix": trd.v.data_ptr() == work.data_ptr()}
        del trd, work
    print(f"compare: tridiagonalize alone, donated working matrix of "
          f"{n * n * 4} bytes: {json.dumps(alone)}", flush=True)
    return out


def memory_phase(device):
    """Whole-solve (mode A) peak device memory of both implementations at
    both sizes, f32.  Prints bytes above the
    resident input and, with the input added, the peak in units of n²·4
    bytes — the constant a rolled-vs-windowed memory rule would need."""
    import torch
    from eigenexa_tpu_torch.testing import frank

    peaks = {}
    for impl, n in (("rolled", N_SLICE), ("windowed", N_SLICE),
                    ("rolled", N_WINDOWED), ("windowed", N_WINDOWED)):
        a = frank(n, torch.float32, device)
        run = _solve_with(device, a, impl, "A")
        peaks[f"{impl}_{n}"] = run["peak_bytes_above_resident"]
        print(f"memory: {impl} n={n} whole solve {run}", flush=True)
        del a
        if device.type == "cuda":
            torch.cuda.empty_cache()
    units = {key: (peak + int(key.split("_")[1]) ** 2 * 4)
             / (int(key.split("_")[1]) ** 2 * 4)
             for key, peak in peaks.items()}
    print(f"memory: whole-solve peak above the resident input, bytes: "
          f"{json.dumps(peaks)}; with the input, in n^2*4 bytes: "
          f"{json.dumps(units)}", flush=True)
    return peaks


def trd_profile(device, n: int) -> None:
    """``--trd-profile N``: torch.profiler over one reduction (mode C) of
    each implementation at Frank n f32: wall seconds, device-busy seconds
    (the sum of kernel times: one stream, so they do not overlap), the
    idle share, the kernel count and the kernels that lead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import householder
    from eigenexa_tpu_torch.testing import frank

    a = frank(n, torch.float32, device)
    old = householder.TRD_IMPL
    walls = {}
    try:
        # walls of both before any profiler has run
        for impl in ("rolled", "windowed", "windowed", "rolled"):
            householder.TRD_IMPL = impl
            walls.setdefault(impl, []).append(
                eigen_s(a, mode="C")[2].elapsed)
        for impl in ("rolled", "windowed"):
            householder.TRD_IMPL = impl
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, _, info = eigen_s(a, mode="C")
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            busy = sum(e.device_time_total for e in events) / 1e6
            count = sum(e.count for e in events)
            top = sorted(events, key=lambda e: -e.device_time_total)[:8]
            wall = walls[impl][1]
            print(f"trd-profile: {impl} n={n} wall unprofiled "
                  f"{walls[impl]} s (cold, warm), profiled "
                  f"{info.elapsed:.4f} s, device busy {busy:.4f} s, idle "
                  f"share of the warm unprofiled wall "
                  f"{1 - busy / wall:.4f}, kernels {count}", flush=True)
            for e in top:
                print(f"trd-profile:   {e.device_time_total / 1e3:10.3f} ms "
                      f"{e.count:8d} x {e.key[:90]}", flush=True)
    finally:
        householder.TRD_IMPL = old


def _kernels_line(rows, launches) -> dict:
    """One entry per kernel at its shape on the windowed path, f32."""
    main_case = {"sub_matmul": "wy_windowed_path",
                 "symv_lower": "first_column",
                 "rank2k_update_window": "first_panel"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    out = []
    for name, meta in KERNELS.items():
        row = next(r for r in rows if r["name"] == name
                   and r["case"] == main_case[name]
                   and r["dtype"] == "float32")
        out.append({"name": name, "route": "cuda", **meta,
                    "launches": launches[name],
                    **{k: row[k] for k in keys}})
    return {"kernels": out}


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
    if sys.argv[1:2] == ["--trd-profile"]:
        trd_profile(device, int(sys.argv[2]))
        print(gpu)
        return 0
    if sys.argv[1:2] == ["--findings"]:
        _timed_phase("compare", compare_phase, device, N_SLICE)
        _timed_phase("memory", memory_phase, device)
        print(gpu)
        return 0

    rows = _timed_phase("kernels sub_matmul", kernel_phase, device, N_SLICE,
                        True)
    rows += _timed_phase("kernels symv_lower", symv_phase, device,
                         N_WINDOWED, True)
    rows += _timed_phase("kernels rank2k_update_window",
                         rank2k_window_phase, device, N_WINDOWED, True)
    torch.cuda.empty_cache()
    rolled, rolled_peak = _timed_phase("slice", slice_phase, device, N_SLICE)
    _timed_phase("f64", f64_phase, device, N_F64)
    windowed, windowed_peak = _timed_phase("windowed", windowed_phase,
                                           device, N_WINDOWED)
    print(f"peak device memory of a warm solve above what was resident: "
          f"rolled n={N_SLICE} {rolled_peak} bytes, windowed "
          f"n={N_WINDOWED} {windowed_peak} bytes", flush=True)
    for path, counts in (("rolled", rolled), ("windowed", windowed)):
        print(f"launches on the {path} path: {json.dumps(counts)}",
              flush=True)
    if not (rolled["sub_matmul"] > 0 and all(
            windowed[name] > 0 for name in KERNELS)):
        raise AssertionError("a kernel of a main path was never launched")

    print(json.dumps(_kernels_line(rows, windowed)))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
