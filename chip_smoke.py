"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero with no
result line:

1. device   — a CUDA card is required (no CPU fallback);
2. build    — builds the hand-written kernels from the checkout's sources
              (``csrc/sub_matmul.cu``, ``csrc/symv_lower.cu``,
              ``csrc/sturm.cu``);
3. kernels  — each kernel through its wrapper against its plain PyTorch
              version on the card, f32 and f64, one ``kernel`` line per
              case with the error and its bound, the kernel's and the plain
              version's time (CUDA events, median), the time of the one
              library call that computes the same (``library_ms``) and the
              least time the card could take (``bound_ms``).  ``ms`` is one
              call with its host side (two events around it, the stream
              drained first); ``device_ms`` and ``library_device_ms`` the
              card's time of one call (50 calls between two events, the
              median of 5 such runs, over 50):
              ``sub_matmul`` at the main paths' shapes, a ragged shape,
              in-place strided views, and shapes that drive the f32
              128-tile kernel through its edges (leading dimensions that
              allow no 16-byte access, k = 5, 130 and 132, a square on
              either side of the launch rule); ``symv_lower`` on a matrix
              whose upper triangle holds garbage (zeros above the window,
              a call into a reused workspace bitwise equal to one that
              makes its own), also in the fused form that the windowed
              column calls (a panel [U | W], its corrections applied in
              the summing pass); ``rank2k_update_window``
              (everything outside the window bitwise untouched);
              ``sturm_bisect`` against its plain version bit for bit, band
              1 and 2, bisection and refinement, on the tridiagonal and
              pentadiagonal of Frank reductions: every index at n = 1024
              (the plain version on the card), 32 indices spread over the
              spectrum at n = 8192 (the plain version on the host's CPU:
              on the card its eager loop would issue millions of
              launches), a failed bracket keeping its w0 at both sizes,
              with the card's time at n = 8192 beside its
              bound and ``torch.linalg.eigvalsh`` on the dense matrix; and
              ``same_bits``: a large ``sub_matmul`` call against the same
              product taken in row blocks, f32 (the launch rule sends the
              blocks to the other f32 kernel) and f64: bitwise equal.  Each
              f64 ``sub_matmul`` line also says whether the DMMA kernel
              gives the plain version's bits (``bitwise_plain``, not gated);
              then ``sub_matmul`` on c64 and c128 (B − P·Qᴴ) at the
              Hermitian path's shapes (the first rolled panel in place on
              its strided view, a WY block), a ragged shape with k = 5 and
              130, the squares on either side of the complex launch rule,
              and its large case in one call (the larger-tile kernel)
              against row blocks small enough for the 64-tile kernel,
              bitwise;
4. slice    — the rolled path: ``eigen_s(frank(8192, float32))`` cold, warm
              and with the stage split; checks residual, orthogonality, the
              scaled eigenvalue error, the kernel launch counts per solve
              and bitwise equality of the cold and warm results;
5. f64      — ``eigen_s(frank(8192, float64))`` through the rolled
              reduction cold, then warm with the stage split and the peak
              device memory, then once with the windowed reduction forced:
              residual and orthogonality PASS, the strict √ε eigenvalue
              check never a hard FAIL (w_scaled printed, not gated), the
              launch counts per solve of both paths, cold and warm bitwise
              equal;
6. windowed — the windowed reduction forced (``householder.TRD_IMPL``):
              ``eigen_s(frank(16384, float32))`` cold, then warm with the
              stage split and the peak device memory; the same checks, and
              launch counts per solve of all three kernels;
7. sx       — ``eigen_sx``, the band-2 path, on Frank matrices: n = 8192
              f32 rolled twice (bitwise equal) and windowed once, n = 8192
              f64 rolled once, n = 16384 f32 windowed once; each with its
              checks, PRD-BLK / D&C / TRDBAK split, peak device memory and
              launch counts (``symv_lower`` nc = 2 a pair,
              ``rank2k_update_window`` a panel, ``sub_matmul``);
8. modes    — ``eigen_s`` and ``eigen_sx`` at Frank n = 8192 f64 in modes
              A, N and X: the strict w_test never a hard FAIL, mode N's w
              within that test of mode A's, ``sturm_bisect`` once a solve;
              then mode R: each reduction's bands saved to a temporary
              directory and solved from there, bitwise equal to the solve
              of the same arrays;
9. hermitian — ``eigen_h`` on the phased Frank matrix D·F·Dᴴ at n = 8192,
              c64 and c128, cold and warm: residual, orthogonality, w_scaled
              (c64) or the strict w_test (c128), 191 ``sub_matmul`` launches
              a solve, bitwise equal reruns, the stage split and peak
              memory, ``torch.linalg.eigh`` on the same matrices (timed, not
              gated); then modes N, X, T, S and C at c128 n = 4096, each
              with its check;
10. gev     — ``eigen_gev`` at n = 8192 f64, A = Frank and B = ``designed
              (linspace(1, 2, n))``: mode A cold and warm (gev_residual,
              b_orthogonality, bitwise equal, 2 × 191 ``sub_matmul``
              launches, the stage split), mode N within the strict w_test
              of mode A's w with one ``sturm_bisect`` launch;
11. large   — Frank n = 32768 f32 through the memory rule ("auto", which
              prints the reduction it chose and the free memory it read):
              ``eigen_s`` twice (bitwise equal) and ``eigen_sx`` once, each
              with residual, orthogonality (Z in blocks of 4096 columns)
              and w_scaled, the stage split, the peak device memory and
              the launches of the chosen reduction; then
              ``torch.linalg.eigh`` at n = 16384 and 32768 f32 in a child
              process, timed and not gated.  Where the rule chose the
              windowed reduction, ``symv_lower`` and
              ``rank2k_update_window`` at that path's first column and
              panel follow.  The kernel phases hold ``sub_matmul`` at this
              path's f32 shapes too (rank-2k 32704²×128, WY 32768²×128).
              The windowed phase and ``sx`` hold their n = 16384 peaks
              below those of the D&C before its top merges were chunked.

Every path is driven with the launch counts set to 0 just before it and
read just after.  The last three lines are the kernels JSON object, the
``nvidia-smi --query-gpu=name,power.limit`` line, and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernels`` stops after the kernel phases: device,
build, what ptxas reports for every kernel (registers, spill, shared
memory), the ``kernel`` lines with their checks and times, the
``nvidia-smi`` line; no solve and no result line.  ``--kernels symv_lower``
(or any names of ``KERNELS``) runs the phases of those kernels only.

Two more modes take findings, check nothing, and print no result line:

``python3 chip_smoke.py --findings`` runs, after the build, ``compare``
(the reduction alone, ``mode="C"``, at n = 8192, rolled and windowed in
turns, and ``tridiagonalize`` alone on a donated working matrix) and
``memory`` (the whole-solve peak device memory of both reductions of
``eigen_s`` and ``eigen_sx`` at n = 8192, 16384 and 32768: the constants
of the memory rule, ``householder.PEAK_N2`` and ``PEAK_MERGE``).

``python3 chip_smoke.py --trd-profile N`` profiles one reduction of each
implementation and each driver (``eigen_s``'s TRD-BLK, ``eigen_sx``'s
PRD-BLK) at Frank n = N with ``torch.profiler`` and prints the
device-busy time, the idle share and the leading kernels.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_SLICE = 8192
N_F64 = 8192
N_WINDOWED = 16384
N_LARGE = 32768
CHECK_CHUNK = 4096   # Z's columns a block in the checks at N_LARGE
# the whole-solve peaks above the resident input at n = 16384 f32 of the
# windowed eigen_s and eigen_sx while the D&C built its top merge whole
# (PERF.md § 5)
UNCHUNKED_PEAK = {"eigen_s": 19_062_710_272, "eigen_sx": 21_211_858_944}
NB_F = 64     # SolverConfig.panel_forward
NB_B = 128    # SolverConfig.panel_backward
KERNELS = {
    "sub_matmul": {
        "source": "eigenexa_tpu_torch/csrc/sub_matmul.cu",
        "replaces": "eigenexa_tpu/ops/pallas_kernels.py:100",
        # the c64 and c128 entry points: complex never reached the Pallas
        # kernel, whose eligibility rule sent it to b - p @ conj(q).T
        "replaces_complex": "eigenexa_tpu/ops/pallas_kernels.py:133 "
                            "(_shape_eligible: complex took the jnp form)"},
    "symv_lower": {
        "source": "eigenexa_tpu_torch/csrc/symv_lower.cu",
        "replaces": "eigenexa_tpu/ops/pallas_kernels.py:212"},
    "rank2k_update_window": {
        "source": "eigenexa_tpu_torch/csrc/sub_matmul.cu",
        "replaces": "eigenexa_tpu/ops/pallas_kernels.py:337"},
    # no TPU kernel: the JAX package's Sturm recurrence is a lax.scan
    # (band 2: sturm.py:145) inside lax.fori_loop, one XLA program
    "sturm_bisect": {
        "source": "eigenexa_tpu_torch/csrc/sturm.cu",
        "replaces": "eigenexa_tpu/ops/sturm.py:51 (lax.scan, not a TPU "
                    "kernel)"},
}
# error bound factor per dtype: only the summation order differs
ERR_C = {"float32": 1e-5, "float64": 1e-13, "complex64": 1e-5,
         "complex128": 1e-13}
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the best rate the card has for exact arithmetic of each type, whether
# or not the kernels reach for it: FP32 on the CUDA cores (TF32 is a lower
# precision), FP64 on the FP64 Tensor Cores (DMMA); a complex type's real
# operations at its real type's rate, 8 of them a complex multiply-add
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "complex64": 67e12,
              "complex128": 67e12}
# FP64 on the CUDA cores (NVIDIA data sheet, H100 SXM): the Sturm recurrence
# is scalar divisions, multiplies and subtractions, no tensor-core shape
PEAK_FP64_CUDA_CORES = 34e12
# f64 operations of one step of the Sturm recurrence (csrc/sturm.cu): band 1
# two subtractions, one division, two comparisons; band 2 two divisions,
# three multiplies, four subtractions, three comparisons
STURM_STEP_OPS = {1: 5, 2: 12}
N_STURM = 1024     # every index checked against the plain version on the card
N_MODES_H = 4096   # eigen_h's modes N, X, T, S and C at c128
ITEMSIZE = {"float32": 4, "float64": 8, "complex64": 8, "complex128": 16}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _want(**counts) -> dict:
    """Launches per kernel of one solve: the named ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNELS}


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
    return _want(symv_lower=panels * nb_f, rank2k_update_window=panels,
                 sub_matmul=-(-(n - 1) // nb_b))


def _sx_panels(n: int, nb_f: int = NB_F) -> int:
    """Panels of the band-2 reduction with a trailing update: the loop runs
    while more than nb + 2 rows are live (ops/band.py)."""
    return max(0, -(-(n - nb_f - 2) // nb_f))


def expected_launches_sx(n: int, windowed: bool, trbak: bool = True,
                         nb_f: int = NB_F, nb_b: int = NB_B) -> dict:
    """Launches of one eigen_sx solve: rolled, one sub_matmul a panel;
    windowed, one symv_lower (nc = 2) a reflector pair and one
    rank2k_update_window a panel; one sub_matmul a WY block of the
    back-transform where the mode runs it."""
    panels = _sx_panels(n, nb_f)
    back = -(-(n - 1) // nb_b) if trbak else 0
    if windowed:
        return _want(symv_lower=panels * nb_f // 2,
                     rank2k_update_window=panels, sub_matmul=back)
    return _want(sub_matmul=panels + back)


def sx_last_t0(n: int, nb_f: int = NB_F) -> int:
    """The window of the band-2 reduction's last panel with a trailing
    update (``householder._win_group_size``'s groups)."""
    from eigenexa_tpu_torch.ops import householder, kernels

    group = householder._win_group_size(n, nb_f)
    return ((_sx_panels(n, nb_f) - 1) * nb_f // group * group
            // kernels.WIN_TM)


def sx_window_launches(n: int, t0: int, nb_f: int = NB_F) -> int:
    """symv_lower launches (nc = 2, one a reflector pair) of one windowed
    eigen_sx solve of n at window t0: the pairs of the panels whose window
    group starts at t0·TM (``ops/band.py`` ``_band2_windowed``)."""
    from eigenexa_tpu_torch.ops import householder, kernels

    group = householder._win_group_size(n, nb_f)
    panels = sum(k // group * group // kernels.WIN_TM == t0
                 for k in range(0, _sx_panels(n, nb_f) * nb_f, nb_f))
    return panels * nb_f // 2


def _reset_launches(kernels) -> None:
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0


def _take_launches(kernels) -> dict:
    """Read the counts of the path just driven, and set them to 0."""
    counts = dict(kernels.LAUNCHES)
    _reset_launches(kernels)
    return counts


def _time_ms(fn, device, reps: int = 10) -> float:
    """The time of one call with its host side (``ms``): two events around
    a single call after the stream has drained, the median of `reps`."""
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


def _device_ms(fn, device, launches: int = 50, batches: int = 5) -> float:
    """The device's time of one call (``device_ms``): one warm-up, then
    `launches` calls between two events, the median of `batches` such runs
    divided by `launches`.  The host enqueues ahead of the card, so its
    side of a call hides unless it is slower than the kernel."""
    import torch

    fn()
    times = []
    stream = torch.cuda.current_stream(device)
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(launches):
            fn()
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _times(row: dict, kernel, plain, library, device, plain_reps=10):
    """``ms`` and ``device_ms`` of the kernel's wrapper, ``plain_ms`` of its
    plain version, ``library_ms`` and ``library_device_ms`` of the library
    call (None where there is none)."""
    row["ms"] = _time_ms(kernel, device)
    row["device_ms"] = _device_ms(kernel, device)
    row["plain_ms"] = _time_ms(plain, device, plain_reps)
    row["library_ms"] = (None if library is None
                         else _time_ms(library, device))
    row["library_device_ms"] = (None if library is None
                                else _device_ms(library, device))


def _bound(dtype: str, elements: float, flops: float) -> dict:
    """The least time the card could take: each input element read once
    and each output element written once at the memory rate, or the
    operations at the peak rate of their type, whichever is larger."""
    t_bytes = elements * ITEMSIZE[dtype] / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def _product_err_bound(dtype: str, b, p, q, k: int) -> float:
    """Bound on |kernel − plain| for B − P·Qᴴ over k terms: 2k real terms
    a complex dot, with the moduli |P|·|Q|."""
    terms = 2 * k if dtype.startswith("complex") else k
    return ERR_C[dtype] * (float(b.abs().max())
                           + terms * float(p.abs().max())
                           * float(q.abs().max()))


def _matmul_ops(dtype: str, m: int, n: int, k: int) -> float:
    """Real operations of B − P·Qᴴ: 2 a real multiply-add, 8 a complex
    one."""
    return (8.0 if dtype.startswith("complex") else 2.0) * m * n * k


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


BIG = 4224          # a square well above the f32 launch rule: 33 x 33 tiles
RULE_SQUARE = 1408  # 11 x 11 tiles of 128: just under one for each of 132 SMs


def kernel_cases(n_main: int, n_win: int, big: int = BIG,
                 rule: int = RULE_SQUARE):
    """(label, m, n, k, view).  `view` None: B contiguous, a fresh output.
    `view` (off, pad, kpad): B is ``buf[off:, off:off + n]`` of an
    (off + m, off + n + pad) buffer and is updated in place, P and Q are
    the first k columns of buffers k + kpad wide.

    The main paths' shapes: the first rolled TRD trailing update (m = n =
    N − 64, k = 2·64), a full WY block of the rolled path (m = n = N,
    k = 128) and of the windowed path's size; a ragged case; an in-place
    strided view.  Then what the f32 128-tile kernel has to get right at
    its edges: a wide view whose last column quad straddles n, the same
    with an odd leading dimension (no 16-byte access to B at all), k below
    one K-slice, k one quad past a slice, k that ends inside a quad of a
    16-byte-aligned row, and a square on either side of the launch rule."""
    return [
        ("rank2k", n_main - 64, n_main - 64, 128, None),
        ("wy", n_main, n_main, 128, None),
        ("wy_windowed_path", n_win, n_win, 128, None),
        ("ragged", 1000, 777, 100, None),
        ("inplace_view", 1063, 1063, 128, (37, 0, 0)),
        ("wide_view", big - 24, big - 127, 128, (0, 103, 0)),
        ("odd_ld_view", big - 24, big - 127, 128, (0, 104, 0)),
        ("k5", big, big, 5, None),
        ("k132", big, big, 132, None),
        ("k130_of_132", big, big, 130, (0, 0, 2)),
        ("under_rule", rule, rule, 128, None),
        ("over_rule", rule + 1, rule + 1, 128, None),
    ]


def kernel_phase(device, n_main: int, timed: bool, n_win: int = N_WINDOWED,
                 **sizes):
    """Compare sub_matmul with its plain version; returns one result row
    per (case, dtype).  `sizes` go to :func:`kernel_cases`."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1234)
    return [_kernel_case(device, gen, dtype, timed, *case)
            for dtype in (torch.float32, torch.float64)
            for case in kernel_cases(n_main, n_win, **sizes)]


def large_kernel_phase(device, n: int = N_LARGE):
    """sub_matmul at the n-sized path's own f32 shapes (the first rolled
    rank-2k panel and a WY block), against its plain version, with bound
    and library times."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5678)
    return [_kernel_case(device, gen, torch.float32, True, *case)
            for case in (("rank2k_large", n - 64, n - 64, 128, None),
                         ("wy_large", n, n, 128, None))]


# The complex launch rules of csrc/sub_matmul.cu: (tile rows, tile
# columns, tiles an SM).  A launch with at least that many tiles for each
# SM takes the larger-tile kernel of its type (c64 64 x 128 on the FMA
# pipes, c128 the cp.async ring on DMMA); the 64 x 64-tile kernel takes
# the rest.  Both rules count 64 x 64 tiles.  A CPU test holds these
# numbers to the source's constants.
COMPLEX_RULE = {"complex64": (64, 64, 1), "complex128": (64, 64, 1)}


def _sm_count(device) -> int:
    """The card's SMs; an H100's 132 for a CPU rehearsal."""
    import torch

    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def complex_kernel_of(dtype: str, m: int, n: int, sms: int) -> str:
    """The kernel that the complex launch rule gives an (m, n) call."""
    tm, tn, factor = COMPLEX_RULE[dtype]
    big = -(-m // tm) * -(-n // tn) >= factor * sms
    return {"complex64": ("c64_wide", "c64"),
            "complex128": ("c128_ring", "c128")}[dtype][not big]


def complex_rule_square(dtype: str, sms: int) -> int:
    """The smallest square that the complex launch rule gives the
    larger-tile kernel."""
    m = 1
    while complex_kernel_of(dtype, m, m, sms) == complex_kernel_of(
            dtype, 1, 1, sms):
        m += 1
    return m


def complex_kernel_cases(n_main: int, rule: int, ragged=(1000, 777)):
    """(label, m, n, k, view) of the complex kernels, as
    :func:`kernel_cases`: the Hermitian path's first rolled panel, in place
    on the view ``work[64:, 64:]`` of the n_main × n_main working matrix,
    a full WY block of its back-transform, a ragged shape with k = 5 and
    with k = 130, the latter in place on an offset view with an odd
    leading dimension, and the squares just under and at `rule`, the
    smallest that the launch rule gives the larger-tile kernel."""
    m, n = ragged
    return [("rank2k", n_main - 64, n_main - 64, 128, (64, 0, 0)),
            ("wy", n_main, n_main, 128, None),
            ("ragged_k5", m, n, 5, None),
            ("ragged_k130", m, n, 130, (37, 3, 2)),
            ("under_rule", rule - 1, rule - 1, 128, None),
            ("over_rule", rule, rule, 128, None)]


def complex_block_rows(dtype: str, n: int, sms: int) -> int:
    """The most rows, a multiple of 8, whose (rows, n) call the launch rule
    gives the 64-tile kernel."""
    block = 0
    while complex_kernel_of(dtype, block + 8, n, sms) in ("c64", "c128"):
        block += 8
    if block == 0:
        raise ValueError(f"no row block of width {n} stays under the "
                         f"{dtype} launch rule")
    return block


def complex_kernel_phase(device, n_main: int, timed: bool, block=None,
                         rule=None, **sizes):
    """sub_matmul on c64 and c128 against its plain version, with
    ``torch.addmm(b, p, q.conj().T, alpha=-1)`` (the JAX package's own form
    of the complex case) as the library call; then the first case in one
    call against the same product in row blocks of `block` rows (by
    default the most that the launch rule gives the 64-tile kernel), bitwise
    equal on the card: the whole call takes the larger-tile kernel, the
    blocks the 64-tile one, and both give the bits of the same real fma
    chains.
    Each row names the kernel the rule gave it (``kernel``).  Returns one
    row per (case, dtype)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5678)
    sms = _sm_count(device)
    rows = []
    for dtype in (torch.complex64, torch.complex128):
        name = _name(dtype)
        cases = complex_kernel_cases(
            n_main, rule=rule or complex_rule_square(name, sms), **sizes)
        rows += [_kernel_case(device, gen, dtype, timed, *case, extra={
            "kernel": complex_kernel_of(name, case[1], case[2], sms)})
            for case in cases]
        _, m, n, k, _ = cases[0]
        rows_b = block or complex_block_rows(name, n, sms)
        pair = [complex_kernel_of(name, m, n, sms),
                complex_kernel_of(name, rows_b, n, sms)]
        if device.type == "cuda" and pair[0] == pair[1]:
            raise AssertionError(f"same_bits_rank2k {name}: the whole call "
                                 f"and its blocks of {rows_b} rows take one "
                                 f"kernel, {pair[0]}")
        rows.append(_same_bits_case(device, gen, dtype, "same_bits_rank2k",
                                    m, n, k, n_main, rows_b,
                                    extra={"kernels": pair}))
    return rows


def _kernel_case(device, gen, dtype, timed: bool, label: str, m: int,
                 n: int, k: int, view, extra=None):
    """One case of :func:`kernel_cases` or :func:`complex_kernel_cases`:
    the kernel against its plain version, timed beside the library call
    and the bound if `timed`."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device)

    if view is None:
        p, q = rnd(m, k), rnd(n, k)
        b = rnd(m, n)
        ref = kernels._sub_matmul_ref(b, p, q)
        out = kernels.sub_matmul(b, p, q)
        outside_ok = True
    else:
        off, pad, kpad = view
        p, q = rnd(m, k + kpad)[:, :k], rnd(n, k + kpad)[:, :k]
        buf = rnd(m + off, n + off + pad)
        inside = torch.zeros(buf.shape, dtype=torch.bool, device=device)
        inside[off:, off:off + n] = True
        before = buf[~inside]
        view = buf[off:, off:off + n]
        b = view.clone()
        ref = kernels._sub_matmul_ref(view, p, q)
        out = kernels.sub_matmul(view, p, q, out=view)
        if out.data_ptr() != view.data_ptr():
            raise AssertionError("in-place call did not write B")
        outside_ok = torch.equal(buf[~inside], before)
        del inside, before
    _sync(device)
    err = float((out - ref).abs().max())
    same = bool(torch.equal(out, ref))
    del out, ref
    name = _name(dtype)
    bound = _product_err_bound(name, b, p, q, k)
    row = {"name": "sub_matmul", "case": label, "dtype": name, "m": m,
           "n": n, "k": k, "max_abs_err": err, "bound": bound,
           **(extra or {})}
    if dtype in (torch.float64, torch.complex128):
        # reported, not gated: whether DMMA gives cuBLAS's bits
        row["bitwise_plain"] = same
    if timed:
        # a view is timed as it is, in place: some hundreds of updates of
        # N(0,1) data by the same product stay finite
        tb = b if view is None else view
        o = torch.empty_like(b) if view is None else view
        _times(row, lambda: kernels.sub_matmul(tb, p, q, out=o),
               lambda: kernels._sub_matmul_ref(tb, p, q),
               lambda: torch.addmm(tb, p, q.conj().T, alpha=-1, out=o),
               device)
        row.update(_bound(name, 2 * m * n + (m + n) * k,
                          _matmul_ops(name, m, n, k)))
        del o, tb
    return _report(row, err <= bound and outside_ok,
                   f"disagrees with its plain version (outside view "
                   f"untouched: {outside_ok})")


def same_bits_phase(device, big: int = BIG, block: int = 384):
    """A large sub_matmul call against the same product taken in blocks of
    `block` rows, in f32 and f64.  In f32 on the card the launch rule sends
    the whole call to the 128-tile kernel and each block to the 64-tile
    kernel, and both sum over k in one order; in f64 both take the DMMA
    kernel, whose sums do not depend on the tile's place.  So the two
    results must be bitwise equal.  The plain versions of a CPU tensor
    promise no such thing: there only the error bound is held.  Returns one
    result row per case."""
    import torch

    gen = torch.Generator(device=device).manual_seed(3412)
    return [_same_bits_case(device, gen, dtype, *case, block)
            for dtype in (torch.float32, torch.float64)
            for case in (("same_bits", big, big, 128, big),
                         ("same_bits_odd_ld", big - 24, big - 127, 100,
                          big - 23))]


def _same_bits_case(device, gen, dtype, label: str, m: int, n: int, k: int,
                    ld: int, block: int, extra=None):
    """B (m, n) with leading dimension ld, in one sub_matmul call and in
    row blocks: bitwise equal on the card, within the bound elsewhere."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device)

    b, p, q = rnd(m, ld)[:, :n], rnd(m, k), rnd(n, k)
    whole = kernels.sub_matmul(b, p, q)
    blocks = torch.empty_like(whole)
    for r0 in range(0, m, block):
        kernels.sub_matmul(b[r0:r0 + block], p[r0:r0 + block], q,
                           out=blocks[r0:r0 + block])
    _sync(device)
    equal = bool(torch.equal(whole, blocks))
    err = float((whole - blocks).abs().max())
    bound = _product_err_bound(_name(dtype), b, p, q, k)
    row = {"name": "sub_matmul", "case": label, "dtype": _name(dtype),
           "m": m, "n": n, "k": k, "block_rows": block, "max_abs_err": err,
           "bound": bound, "bitwise_equal": equal, **(extra or {})}
    return _report(row, equal if device.type == "cuda" else err <= bound,
                   "whole and in row blocks give other bits")


def symv_cases(m_main: int, m_f64: int):
    """(label, m, t0, nc, fused) per dtype: the first column of the f32
    windowed path (the full matrix), a window further down, the two-vector
    pass, a ragged size; f64 adds the f64 windowed path's own matrix
    (m_f64), its first column and a window further down.  Then the fused
    form that the windowed column calls (``fused`` True: one vector, the
    panel's corrections applied): f32 at m_main at the first, a middle and
    the last window group of an n = m_main solve, f64 at m_f64 at its
    first and a middle one.  Last, the band-2 path's own pair pass (nc = 2,
    ``sx_``): f32 at m_f64 and m_main and f64 at m_f64, each at its first
    window and at the window of its last panel."""
    cases = [("first_column", m_main, 0, 1, False),
             ("window", m_main, 16, 1, False),
             ("pair", m_main, 0, 2, False), ("ragged", 1837, 1, 1, False)]
    sx = [("sx_pair_first", m_f64, 0, 2, False),
          ("sx_pair_last", m_f64, sx_last_t0(m_f64), 2, False)]
    f64 = cases + [("f64_path_first_column", m_f64, 0, 1, False),
                   ("f64_path_window", m_f64, 8, 1, False),
                   ("fused_f64_path_first_column", m_f64, 0, 1, True),
                   ("fused_f64_path_window", m_f64, 8, 1, True)] + sx
    return {"float32": cases + [("fused_first_column", m_main, 0, 1, True),
                                ("fused_window", m_main, 16, 1, True),
                                ("fused_late_window", m_main, 28, 1, True)]
            + sx + [("sx_pair_last_large", m_main, sx_last_t0(m_main), 2,
                     False)],
            "float64": f64}


def symv_phase(device, m_main: int, timed: bool, m_f64: int = N_F64,
               cases=None):
    """Compare symv_lower with its plain version on a matrix whose upper
    triangle is garbage; returns one result row per (case, dtype).  A fused
    case hands it a panel [U | W] of NB_F columns a half, NB_F − 1 of them
    filled (the last column of a panel) and zero above the window, as the
    windowed column does.  The first call makes its own workspace, the
    second reuses one that the timed calls reuse too: the two must give
    the same bits.  ``cases`` replaces :func:`symv_cases`."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    rows = []
    gen = torch.Generator(device=device).manual_seed(4321)
    cases = cases or symv_cases(m_main, m_f64)
    for dtype in (torch.float32, torch.float64):
        for label, m, t0, nc, fused in cases.get(_name(dtype), ()):
            w0 = t0 * kernels.WIN_TM
            if w0 >= m:
                raise AssertionError(f"case {label}: window outside m={m}")
            b = torch.randn(m, m, generator=gen, dtype=dtype, device=device)
            # lower triangle: the symmetric matrix; upper: garbage
            b.triu_(1).mul_(1e6).add_(torch.randn(
                m, m, generator=gen, dtype=dtype, device=device).tril_())
            x = torch.randn(*((m,) if nc == 1 else (m, nc)), generator=gen,
                            dtype=dtype, device=device)
            kw, nb, corr = {}, 0, 0.0
            if fused:
                nb = NB_F - 1
                uw = torch.zeros(m, 2 * NB_F, dtype=dtype, device=device)
                for half in (0, NB_F):
                    uw[w0:, half:half + nb] = torch.randn(
                        m - w0, nb, generator=gen, dtype=dtype,
                        device=device)
                kw = {"panel": uw, "nb": nb}
                g = uw[w0:].T @ x[w0:]
                corr = 2 * nb * float(uw.abs().max()) * float(g.abs().max())
            ws = kernels.symv_workspace(b, t0, nc, 2 * NB_F if fused else 0)
            ref = kernels._symv_lower_ref(b, x, t0, **kw)
            out = kernels.symv_lower(b, x, t0=t0, **kw)
            again = kernels.symv_lower(b, x, t0=t0, **kw, **ws)
            _sync(device)
            err = float((out - ref).abs().max())
            low_max = float(torch.tril(b[w0:, w0:]).abs().max())
            # a sum of m products in another order: the rounding grows
            # like sqrt(m), and a tile counted twice or dropped is O(1);
            # the corrections add 2·nb products a row
            bound = ERR_C[_name(dtype)] * (m ** 0.5 * low_max
                                           * float(x.abs().max()) + corr)
            zeros_above = not bool(out[:w0].any())
            repeats = bool(torch.equal(out, again))
            del ref, again
            mw = m - w0
            row = {"name": "symv_lower", "case": label,
                   "dtype": _name(dtype), "m": m, "t0": t0, "nc": nc,
                   "fused_panel_columns": nb, "max_abs_err": err,
                   "bound": bound, "zeros_above_window": zeros_above,
                   "bitwise_repeat": repeats}
            if label.startswith("sx_"):
                row["launches_at_window"] = sx_window_launches(m, t0)
            if timed:
                # the call as the windowed column makes it: into a workspace
                win, xw = b[w0:, w0:], x[w0:]
                _times(row, lambda: kernels.symv_lower(b, x, t0=t0, **kw,
                                                       **ws),
                       lambda: kernels._symv_lower_ref(b, x, t0, **kw),
                       (lambda: torch.mv(win, xw)) if nc == 1
                       else (lambda: torch.matmul(win, xw)), device, 3)
                # the triangle, X, Q, and the panel's filled columns and g
                row.update(_bound(_name(dtype),
                                  mw * (mw + 1) / 2 + 2 * m * nc
                                  + 2 * nb * (mw + 1),
                                  2.0 * mw * mw * nc + 4.0 * mw * nb))
            rows.append(_report(
                row, err <= bound and zeros_above and repeats,
                "disagrees with its plain version, is not zero above the "
                "window or does not repeat bitwise"))
            del b, x, ws, kw
    return rows


def rank2k_window_cases(m_main: int, m_f64: int):
    """(label, m, t0) per dtype: the first panel of the f32 windowed path,
    a window further down, a ragged size; then two windows large enough for
    the f32 128-tile kernel whose edge is no multiple of its tile, one of
    them with an odd leading dimension; f64 adds the f64 windowed path's
    own matrix (m_f64), its first panel and a window further down.
    k = 2·64."""
    cases = [("first_panel", m_main, 0), ("window", m_main, 8),
             ("ragged", 1837, 1), ("ragged_large", 4500, 1),
             ("odd_ld_large", 4501, 1)]
    return {"float32": cases,
            "float64": cases + [("f64_path_first_panel", m_f64, 0),
                                ("f64_path_window", m_f64, 8)]}


def rank2k_window_phase(device, m_main: int, timed: bool,
                        m_f64: int = N_F64, cases=None):
    """Compare rank2k_update_window with its plain version; returns one
    result row per (case, dtype).  ``cases`` replaces
    :func:`rank2k_window_cases`."""
    import torch
    from eigenexa_tpu_torch.ops import kernels

    rows = []
    nb = NB_F
    gen = torch.Generator(device=device).manual_seed(2143)
    cases = cases or rank2k_window_cases(m_main, m_f64)
    for dtype in (torch.float32, torch.float64):
        for label, m, t0 in cases.get(_name(dtype), ()):
            w0 = t0 * kernels.WIN_TM
            if w0 >= m:
                raise AssertionError(f"case {label}: window outside m={m}")

            def rnd(*shape):
                return torch.randn(*shape, generator=gen, dtype=dtype,
                                   device=device)

            b, u, w = rnd(m, m), rnd(m, nb), rnd(m, nb)
            bound = _product_err_bound(_name(dtype), b, u, w, 2 * nb)
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
                # timed in place: some hundreds of updates of N(0,1) data
                # by the same product stay finite
                p = torch.cat([u, w], dim=1)[w0:]
                qt = torch.cat([w, u], dim=1)[w0:].T
                win = b[w0:, w0:]
                _times(row,
                       lambda: kernels.rank2k_update_window(b, u, w, t0=t0),
                       lambda: kernels._rank2k_window_ref(b, u, w, t0),
                       lambda: win.addmm_(p, qt, alpha=-1), device)
                row.update(_bound(_name(dtype),
                                  2 * mw * mw + 2 * mw * 2 * nb,
                                  2.0 * mw * mw * 2 * nb))
            rows.append(_report(
                row, err <= bound and outside_ok,
                "disagrees with its plain version or wrote outside its "
                "window"))
    return rows


def frank_bands(device, n: int) -> dict:
    """The bands of the two reductions of Frank n in f64, the Sturm
    kernel's operands on the main path: {1: (d, e, None), 2: (d, e1,
    e2)}."""
    import torch
    from eigenexa_tpu_torch.ops import band, householder
    from eigenexa_tpu_torch.testing import frank

    a = frank(n, torch.float64, device)
    trd = householder.tridiagonalize(a, nb=NB_F)
    prd = band.band2_reduce(a, nb=NB_F, donate=True)
    return {1: (trd.d, trd.e, None), 2: (prd.d, prd.e1, prd.e2)}


def sturm_phase(device, n_small: int = N_STURM, n_large: int = N_F64,
                timed: bool = True, samples: int = 32):
    """Compare sturm_bisect with its plain version, bit for bit, on the
    tridiagonal (band 1) and the pentadiagonal (band 2) of Frank
    reductions: the bisection of modes N (70 steps from the Gershgorin
    brackets) and the refinement of mode X (45 steps from brackets around
    w0, with the two counts of the valid check; w0 is the library's
    eigenvalues with index n // 3 pushed outside its bracket, which must
    come back as it went in, at both sizes).  At n_small every index
    against the plain version on the same device; at n_large `samples`
    indices (n // 3 and others spread over the spectrum) against the plain
    version on copies on the host's CPU (each index's bracket evolves
    alone).  Timed: the kernel's call and device
    time at n_large, the plain version's at n_small, the library's
    eigenvalues of the dense matrix, and the bound: the recurrence's f64
    operations at the FP64 CUDA-core peak.  Returns one row per case."""
    import torch
    from eigenexa_tpu_torch.ops import band, kernels, sturm

    rows = []
    cpu = torch.device("cpu")
    for n in (n_small, n_large):
        bands = frank_bands(device, n)
        for b, (d, e1, e2) in bands.items():
            dense = (band.assemble_band2(d, e1, e2) if b == 2 else
                     torch.diag(d) + torch.diag(e1, 1) + torch.diag(e1, -1))
            library = torch.linalg.eigvalsh(dense)
            w0 = library.clone()
            w0[n // 3] += 10.0 * float(library.abs().max())
            for op, n_iter, valid in (("bisect", 70, False),
                                      ("refine", 45, True)):
                ends = (sturm.refine_brackets(w0) if valid
                        else sturm.bisect_brackets(d, e1, e2))
                args = (d, e1, e2, *ends, n_iter, valid, w0)
                got = kernels.sturm_bisect(*args)
                _sync(device)
                kept = not valid or float(got[n // 3]) == float(w0[n // 3])
                idx = None
                on = device
                if n == n_large:
                    spread = torch.linspace(0, n - 1, samples - 1).round()
                    idx = torch.cat([spread.long(), torch.tensor([n // 3])])
                    on = cpu
                    got = got.cpu()[idx]
                plain_args = [None if x is None else
                              (x.to(on) if isinstance(x, torch.Tensor)
                               else x) for x in args]
                t0 = time.perf_counter()
                plain = kernels._sturm_bisect_ref(*plain_args, idx=idx)
                _sync(on)
                plain_s = time.perf_counter() - t0
                got, plain = got.cpu(), plain.cpu()
                equal = bool(torch.equal(got, plain))
                err = float((got - plain).abs().max())
                row = {"name": "sturm_bisect", "case": f"{op}_band{b}",
                       "dtype": "float64", "n": n, "band": b,
                       "n_iter": n_iter, "indices_checked": int(
                           n if idx is None else idx.numel()),
                       "plain_on": on.type, "max_abs_err": err,
                       "bitwise_equal": equal,
                       "failed_bracket_keeps_w0": kept}
                if timed and n == n_small:
                    row["plain_ms"] = plain_s * 1e3
                if timed and n == n_large:
                    def kernel(args=args):
                        return kernels.sturm_bisect(*args)
                    row["ms"] = _time_ms(kernel, device, 3)
                    row["device_ms"] = _device_ms(kernel, device, 3, 3)
                    row["library_ms"] = _time_ms(
                        lambda: torch.linalg.eigvalsh(dense), device, 2)
                    sweeps = n_iter + (2 if valid else 0)
                    ops = float(n) * sweeps * n * STURM_STEP_OPS[b]
                    row.update(step_ops=STURM_STEP_OPS[b], operations=ops,
                               bound_ms=ops / PEAK_FP64_CUDA_CORES * 1e3,
                               bound_by="operations")
                rows.append(_report(row, equal and kept,
                                    "differs from its plain version"))
            del dense, library
        del bands
    return rows


def _check_solution(label, a, w, z, w_true, others, col_chunk: int = 0):
    """Shapes, finiteness, the reference's three checks (Z streamed in
    blocks of `col_chunk` columns where it is not 0), and bitwise equality
    with the solves in `others` ({name: (w, z)})."""
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
    res = residual_check(a, z, w, col_chunk=col_chunk)
    orth = orthogonality_check(z, col_chunk=col_chunk)
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
    want = _want(sub_matmul=expected_launches(n))
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


def _check_f64(label, a, w, z, w_true) -> None:
    """Residual and orthogonality PASS, the strict √ε w_test never a hard
    FAIL (CAUTION allowed, as in the JAX package's rule); w_scaled is
    printed beside it and not gated."""
    from eigenexa_tpu_torch.testing import (eigenvalue_check,
                                            eigenvalue_check_scaled,
                                            orthogonality_check,
                                            residual_check)

    if w.shape != (a.shape[0],) or z.shape != a.shape or z.dtype != a.dtype:
        raise AssertionError(f"{label}: bad output shapes/dtypes {w.shape} "
                             f"{z.shape} {z.dtype}")
    res = residual_check(a, z, w)
    orth = orthogonality_check(z)
    wt = eigenvalue_check(w, w_true)
    wsc = eigenvalue_check_scaled(w, w_true)
    print(f"{label} checks: {res} {orth} {wt} {wsc} (w_scaled not gated)",
          flush=True)
    if not (res.passed and orth.passed and (wt.passed or wt.caution)):
        raise AssertionError(f"{label} checks failed")


def f64_phase(device, n: int):
    """The f64 path at Frank n: eigen_s through the rolled reduction cold,
    then warm with the stage split and the peak device memory, then once
    with the windowed reduction forced (``householder.TRD_IMPL``).  Each
    solve passes :func:`_check_f64` and has the launch counts of its path;
    the cold and warm solves are bitwise equal.  Returns the launches of
    the cold rolled solve and of the windowed one."""
    import torch
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import householder, kernels
    from eigenexa_tpu_torch.testing import frank, frank_spectrum

    a = frank(n, torch.float64, device)
    w_true = frank_spectrum(n, torch.float64, device)
    want = _want(sub_matmul=expected_launches(n))
    want_win = expected_launches_windowed(n)
    _reset_launches(kernels)
    w1, z1, cold = eigen_s(a)
    counts = [_take_launches(kernels)]
    resident = _mem_mark(device)
    w2, z2, warm = eigen_s(a, profile=True)
    peak = _mem_peak(device, resident)
    counts.append(_take_launches(kernels))
    same = bool(torch.equal(w1, w2) and torch.equal(z1, z2))
    del w1, z1
    print(f"f64: Frank n={n} eigen_s rolled cold {cold.elapsed:.4f} s, warm "
          f"(profiled) {warm.elapsed:.4f} s = {warm.gflops:.2f} GFLOP/s "
          f"(flop_model {warm.flops:.6g}); cold and warm bitwise equal: "
          f"{same}", flush=True)
    warm.stage_report(lambda s: print("f64 stage" + s, flush=True))
    print(f"f64: peak device memory of the warm solve above what was "
          f"resident before it: {peak} bytes; resident {resident} bytes",
          flush=True)
    _check_f64("f64 rolled", a, w2, z2, w_true)
    del w2, z2
    old = householder.TRD_IMPL
    householder.TRD_IMPL = "windowed"
    try:
        w3, z3, win = eigen_s(a)
        counts.append(_take_launches(kernels))
    finally:
        householder.TRD_IMPL = old
    print(f"f64: Frank n={n} eigen_s windowed {win.elapsed:.4f} s; launches "
          f"per solve {counts} (expected {[want, want, want_win]})",
          flush=True)
    _check_f64("f64 windowed", a, w3, z3, w_true)
    if counts != [want, want, want_win]:
        raise AssertionError(f"f64 launch counts {counts}")
    if not same:
        raise AssertionError("f64: cold and warm solves differ")
    return counts[0], counts[2]


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
    if n == N_WINDOWED and peak >= UNCHUNKED_PEAK["eigen_s"]:
        raise AssertionError(f"windowed: peak {peak} bytes is not below the "
                             f"unchunked D&C's {UNCHUNKED_PEAK['eigen_s']}")
    return counts[0], peak


def _solve_sx(device, a, impl: str, label: str, want: dict,
              profile: bool = True):
    """One eigen_sx with the reduction forced to `impl`, its launch counts
    held to `want`; prints the time, the stage split and the peak device
    memory above what was resident before it.  Returns (w, z)."""
    from eigenexa_tpu_torch import eigen_sx
    from eigenexa_tpu_torch.ops import householder, kernels

    old = householder.TRD_IMPL
    householder.TRD_IMPL = impl
    try:
        _reset_launches(kernels)
        resident = _mem_mark(device)
        w, z, info = eigen_sx(a, profile=profile)
        peak = _mem_peak(device, resident)
        counts = _take_launches(kernels)
    finally:
        householder.TRD_IMPL = old
    print(f"sx: {label} {info.elapsed:.4f} s = {info.gflops:.2f} GFLOP/s; "
          f"peak device memory above the resident {resident} bytes: {peak} "
          f"bytes; launches {json.dumps(counts)} (expected "
          f"{json.dumps(want)})", flush=True)
    info.stage_report(lambda line: print(f"sx {label} stage" + line,
                                         flush=True))
    if counts != want:
        raise AssertionError(f"sx {label}: launch counts {counts} != {want}")
    return w, z, counts, peak


def sx_phase(device, n: int = N_SLICE, n_large: int = N_WINDOWED):
    """eigen_sx, the band-2 path, on Frank matrices: n f32 rolled twice
    (the reruns bitwise equal) and windowed once, n f64 rolled once,
    n_large f32 windowed once.  Each passes the checks of its dtype and
    has its schedule's launch counts.  Returns the launches of the rolled
    and the windowed f32 solves at n."""
    import torch
    from eigenexa_tpu_torch.testing import frank, frank_spectrum

    rolled, windowed = (expected_launches_sx(n, w) for w in (False, True))
    a = frank(n, torch.float32, device)
    w_true = frank_spectrum(n, torch.float64)
    w1, z1, counts, _ = _solve_sx(device, a, "rolled", f"n={n} f32 rolled",
                                  rolled, profile=False)
    w2, z2, _, _ = _solve_sx(device, a, "rolled",
                             f"n={n} f32 rolled rerun", rolled)
    same = _check_solution("sx f32 rolled", a, w2, z2, w_true,
                           {"first": (w1, z1)})
    if not same["first"]:
        raise AssertionError("sx: the rolled reruns differ")
    del w1, z1, w2, z2
    w, z, counts_win, _ = _solve_sx(device, a, "windowed",
                                    f"n={n} f32 windowed", windowed)
    _check_solution("sx f32 windowed", a, w, z, w_true, {})
    del a, w, z
    a = frank(n, torch.float64, device)
    w, z, _, _ = _solve_sx(device, a, "rolled", f"n={n} f64 rolled",
                           rolled)
    _check_f64("sx f64 rolled", a, w, z,
               frank_spectrum(n, torch.float64, device))
    del a, w, z
    _empty_cache(device)
    a = frank(n_large, torch.float32, device)
    w, z, _, peak = _solve_sx(device, a, "windowed",
                              f"n={n_large} f32 windowed",
                              expected_launches_sx(n_large, True))
    _check_solution("sx f32 windowed large", a, w, z,
                    frank_spectrum(n_large, torch.float64), {})
    if n_large == N_WINDOWED and peak >= UNCHUNKED_PEAK["eigen_sx"]:
        raise AssertionError(f"sx: peak {peak} bytes at n={n_large} is not "
                             f"below the unchunked D&C's "
                             f"{UNCHUNKED_PEAK['eigen_sx']}")
    del a, w, z
    _empty_cache(device)
    return counts, counts_win


def _empty_cache(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def modes_phase(device, n: int = N_F64):
    """Modes N, X and A of eigen_s and eigen_sx at Frank n f64: the strict
    w_test never a hard FAIL, mode N's w within that test of mode A's,
    mode X's vectors through the f64 checks, one sturm_bisect launch a
    solve of modes N and X.  Then mode R: each reduction's bands saved to
    a temporary directory and solved from there, bitwise equal to the
    solve of the same arrays, no kernel launched.  Returns the launches
    of all the mode N and X solves together."""
    import torch
    from eigenexa_tpu_torch import eigen_s, eigen_sx
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import (eigenvalue_check, frank,
                                            frank_spectrum)

    a = frank(n, torch.float64, device)
    w_true = frank_spectrum(n, torch.float64, device)
    sturm_path = _want()
    drivers = (("eigen_s", eigen_s, expected_launches(n),
                _full_panels(n, NB_F)),
               ("eigen_sx", eigen_sx,
                expected_launches_sx(n, False)["sub_matmul"],
                _sx_panels(n)))
    for name, drive, full, no_back in drivers:
        w_a = None
        for mode in "ANX":
            want = _want(sub_matmul=no_back if mode == "N" else full,
                         sturm_bisect=int(mode in "NX"))
            _reset_launches(kernels)
            w, z, info = drive(a, mode=mode, profile=True)
            counts = _take_launches(kernels)
            label = f"modes {name} {mode}"
            print(f"{label}: Frank n={n} f64 {info.elapsed:.4f} s; "
                  f"launches {json.dumps(counts)} (expected "
                  f"{json.dumps(want)})", flush=True)
            info.stage_report(lambda line, label=label: print(
                f"{label} stage" + line, flush=True))
            if counts != want:
                raise AssertionError(f"{label}: launch counts {counts}")
            if mode in "NX":
                for key in sturm_path:
                    sturm_path[key] += counts[key]
            if mode == "N":
                wt = eigenvalue_check(w, w_true)
                wa = eigenvalue_check(w, w_a)
                print(f"{label} checks: {wt}, against mode A's w {wa}",
                      flush=True)
                if z is not None or not all(c.passed or c.caution
                                            for c in (wt, wa)):
                    raise AssertionError(f"{label} checks failed")
            else:
                _check_f64(label, a, w, z, w_true)
            if mode == "A":
                w_a = w
            del w, z
    _empty_cache(device)
    _mode_r(device, n, w_true)
    return sturm_path


def _mode_r(device, n: int, w_true) -> None:
    """Mode R of both drivers on the bands of Frank n's two reductions:
    from a directory of D.data/E.data[/F.data] and from the arrays
    themselves."""
    import torch
    from eigenexa_tpu_torch import EigenContext, eigen_s, eigen_sx
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import eigenvalue_check
    from eigenexa_tpu_torch.utils.stageio import save_stage_data

    bands = frank_bands(device, n)
    ctx = EigenContext(device=device)
    with tempfile.TemporaryDirectory() as tmp:
        for name, drive, b in (("eigen_s", eigen_s, 1),
                               ("eigen_sx", eigen_sx, 2)):
            arrays = tuple(x for x in bands[b] if x is not None)
            path = os.path.join(tmp, name)
            save_stage_data(path, *arrays)
            _reset_launches(kernels)
            w_f, z_f, info = drive(None, mode="R", stage_data=path, ctx=ctx)
            w_t, z_t, _ = drive(None, mode="R", stage_data=arrays, ctx=ctx)
            counts = _take_launches(kernels)
            same = bool(torch.equal(w_f, w_t) and torch.equal(z_f, z_t))
            wt = eigenvalue_check(w_f, w_true)
            print(f"modes {name} R: {len(arrays)} bands through "
                  f"{sorted(os.listdir(path))} {info.elapsed:.4f} s; bitwise "
                  f"equal to the solve of the arrays: {same}; {wt}; "
                  f"launches {json.dumps(counts)}", flush=True)
            if not (same and (wt.passed or wt.caution)
                    and counts == _want() and z_f.shape == (n, n)):
                raise AssertionError(f"modes {name} R failed")
            del w_f, z_f, w_t, z_t


def _check_hermitian(label, a, w, z, w_true, strict: bool) -> None:
    """Shapes and finiteness; residual and orthogonality PASS; in c64
    w_scaled of w cast to f32 PASS (as the f32 eigen_s phase holds it); in
    c128 the strict √ε w_test never a hard FAIL, w_scaled printed."""
    import torch
    from eigenexa_tpu_torch.testing import (eigenvalue_check,
                                            eigenvalue_check_scaled,
                                            orthogonality_check,
                                            residual_check)

    n = a.shape[0]
    if w.shape != (n,) or z.shape != (n, n) or z.dtype != a.dtype:
        raise AssertionError(f"{label}: bad output shapes/dtypes {w.shape} "
                             f"{z.shape} {z.dtype}")
    if not bool(torch.isfinite(w).all() & torch.isfinite(z).all()):
        raise AssertionError(f"{label}: non-finite eigenpairs")
    res = residual_check(a, z, w)
    orth = orthogonality_check(z)
    real = torch.float64 if strict else torch.float32
    wsc = eigenvalue_check_scaled(w.to(real), w_true)
    ok = res.passed and orth.passed
    if strict:
        wt = eigenvalue_check(w, w_true)
        ok = ok and (wt.passed or wt.caution)
        print(f"{label} checks: {res} {orth} {wt} {wsc} (w_scaled not "
              f"gated)", flush=True)
    else:
        ok = ok and wsc.passed
        print(f"{label} checks: {res} {orth} {wsc}", flush=True)
    if not ok:
        raise AssertionError(f"{label} checks failed")


def hermitian_phase(device, n: int = N_SLICE, n_modes: int = N_MODES_H):
    """eigen_h on the phased Frank matrix D·F·Dᴴ (``frank_hermitian``,
    Frank's exact spectrum): c64 and c128 cold, then warm with the stage
    split and the peak device memory; each with its checks
    (:func:`_check_hermitian`), the sub_matmul launches of a rolled solve
    and bitwise equal cold and warm solves.  Then torch.linalg.eigh on the
    same matrices (the incumbent, timed cold and warm, not gated), and
    modes N, X, T, S and C at c128 n_modes beside mode A, each with its
    check.  Returns the launches of the cold c64 and c128 solves."""
    import torch
    from eigenexa_tpu_torch import eigen_h
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import frank_hermitian, frank_spectrum

    w_true = frank_spectrum(n, torch.float64, device)
    want = _want(sub_matmul=expected_launches(n))
    launches = {}
    for dtype in (torch.complex64, torch.complex128):
        name = _name(dtype)
        a = frank_hermitian(n, dtype, seed=0, device=device)
        _reset_launches(kernels)
        w1, z1, cold = eigen_h(a)
        counts = [_take_launches(kernels)]
        resident = _mem_mark(device)
        w2, z2, warm = eigen_h(a, profile=True)
        peak = _mem_peak(device, resident)
        counts.append(_take_launches(kernels))
        same = bool(torch.equal(w1, w2) and torch.equal(z1, z2))
        del w1, z1
        print(f"hermitian: Frank-phased n={n} {name} eigen_h cold "
              f"{cold.elapsed:.4f} s, warm {warm.elapsed:.4f} s = "
              f"{warm.gflops:.2f} GFLOP/s (4x flop_model {warm.flops:.6g}); "
              f"peak device memory of the warm solve above the resident "
              f"{resident} bytes: {peak} bytes; launches per solve "
              f"{counts} (expected {want}); cold and warm bitwise equal: "
              f"{same}", flush=True)
        warm.stage_report(lambda line, name=name: print(
            f"hermitian {name} stage" + line, flush=True))
        _check_hermitian(f"hermitian {name}", a, w2, z2, w_true,
                         strict=dtype == torch.complex128)
        if counts != [want] * 2 or not same:
            raise AssertionError(f"hermitian {name}: launch counts {counts} "
                                 f"or cold and warm differ")
        launches[name] = counts[0]
        del w2, z2
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            we, _ = torch.linalg.eigh(a)
            _sync(device)
            times.append(time.perf_counter() - t0)
        print(f"hermitian: incumbent torch.linalg.eigh on the same {name} "
              f"matrix: cold {times[0]:.4f} s, warm {times[1]:.4f} s; "
              f"max |w - w_true| {float((we.double() - w_true).abs().max())}"
              , flush=True)
        del a, we
        _empty_cache(device)
    _hermitian_modes(device, n_modes)
    return launches["complex64"], launches["complex128"]


def _hermitian_modes(device, n: int) -> None:
    """Modes A, N, X, T, S and C of eigen_h at c128 n on the phased Frank
    matrix: N within the strict w_test of A's values (the dense eigvalsh of
    T); X bitwise A's (no refinement); T with A's values and the real,
    orthonormal vectors of T; S with Q's orthonormal columns and C with
    the identity, both with T's diagonal, whose sum is A's trace.  Each
    with the sub_matmul launches its stages make."""
    import torch
    from eigenexa_tpu_torch import eigen_h
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import (eigenvalue_check,
                                            frank_hermitian, frank_spectrum,
                                            orthogonality_check)

    a = frank_hermitian(n, torch.complex128, seed=1, device=device)
    w_true = frank_spectrum(n, torch.float64, device)
    trace = float(a.diagonal().real.sum())
    panels, full = _full_panels(n, NB_F), expected_launches(n)
    w_a = z_a = None
    for mode in "ANXTSC":
        _reset_launches(kernels)
        w, z, info = eigen_h(a, mode=mode)
        counts = _take_launches(kernels)
        want = _want(sub_matmul=full if mode in "AXS" else panels)
        label = f"hermitian modes {mode}"
        if mode == "A":
            _check_hermitian(label, a, w, z, w_true, strict=True)
            w_a, z_a = w, z
            ok = True
        elif mode == "N":
            wt, wa = eigenvalue_check(w, w_true), eigenvalue_check(w, w_a)
            print(f"{label} checks: {wt}, against mode A's w {wa}",
                  flush=True)
            ok = z is None and all(c.passed or c.caution for c in (wt, wa))
        elif mode == "X":
            ok = bool(torch.equal(w, w_a) and torch.equal(z, z_a))
        elif mode == "T":
            orth = orthogonality_check(z)
            ok = (bool(torch.equal(w, w_a)) and not bool(z.imag.any())
                  and orth.passed)
            print(f"{label} checks: {orth}", flush=True)
        else:
            rel = abs(float(w.sum()) - trace) / abs(trace)
            orth = orthogonality_check(z)
            ok = rel < 1e-10 and orth.passed
            if mode == "C":
                ok = ok and bool(torch.equal(
                    z, torch.eye(n, dtype=z.dtype, device=device)))
            print(f"{label} checks: sum of T's diagonal against the trace "
                  f"{rel:.3g}, {orth}", flush=True)
        print(f"{label}: n={n} c128 {info.elapsed:.4f} s; launches "
              f"{json.dumps(counts)} (expected {json.dumps(want)}); "
              f"checks held: {ok}", flush=True)
        if not ok or counts != want:
            raise AssertionError(f"{label} failed")
        del w, z
    del a, w_a, z_a
    _empty_cache(device)


def gev_phase(device, n: int = N_F64):
    """eigen_gev at n f64: A = Frank, B = ``designed(linspace(1, 2, n))``
    built on the card.  Mode A cold, then warm with the stage split
    (eigen_s(B), F and FᵀAF, eigen_s(A′), F·Z′) and the peak device memory:
    gev_residual and b_orthogonality PASS, bitwise equal, 2 × 191
    sub_matmul launches (two rolled eigen_s solves).  Mode N: its w within
    the strict w_test of mode A's, one sturm_bisect launch.  Returns the
    launches of the cold mode A solve and of mode N."""
    import torch
    from eigenexa_tpu_torch import eigen_gev
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.testing import (b_orthogonality_check, designed,
                                            eigenvalue_check, frank,
                                            gev_residual_check)

    a = frank(n, torch.float64, device)
    b = designed(torch.linspace(1.0, 2.0, n, dtype=torch.float64), seed=0,
                 device=device)
    want = _want(sub_matmul=2 * expected_launches(n))
    _reset_launches(kernels)
    w1, z1, cold = eigen_gev(a, b)
    counts = [_take_launches(kernels)]
    resident = _mem_mark(device)
    w2, z2, warm = eigen_gev(a, b, profile=True)
    peak = _mem_peak(device, resident)
    counts.append(_take_launches(kernels))
    warm.stage_report(lambda line: print("gev stage" + line, flush=True))
    same = bool(torch.equal(w1, w2) and torch.equal(z1, z2))
    del w1, z1
    res = gev_residual_check(a, b, z2, w2)
    orth = b_orthogonality_check(z2, b)
    print(f"gev: Frank / designed n={n} f64 eigen_gev cold "
          f"{cold.elapsed:.4f} s, warm {warm.elapsed:.4f} s = "
          f"{warm.gflops:.2f} GFLOP/s (gev_flop_model {warm.flops:.6g}); "
          f"peak device memory above the resident {resident} bytes: {peak} "
          f"bytes; launches {counts} (expected {want}); cold and warm "
          f"bitwise equal: {same}; checks: {res} {orth}", flush=True)
    if not (res.passed and orth.passed and same and counts == [want] * 2):
        raise AssertionError("gev mode A failed")
    del z2
    want_n = _want(sub_matmul=expected_launches(n) + _full_panels(n, NB_F),
                   sturm_bisect=1)
    _reset_launches(kernels)
    w_n, z_n, info_n = eigen_gev(a, b, mode="N")
    counts_n = _take_launches(kernels)
    wa = eigenvalue_check(w_n, w2)
    print(f"gev N: n={n} f64 {info_n.elapsed:.4f} s; launches "
          f"{json.dumps(counts_n)} (expected {json.dumps(want_n)}); against "
          f"mode A's w {wa}", flush=True)
    if z_n is not None or not (wa.passed or wa.caution) or counts_n != want_n:
        raise AssertionError("gev mode N failed")
    del a, b, w2, w_n
    _empty_cache(device)
    return counts[0], counts_n


def _solve_large(device, drive, a, label: str, want_of):
    """One profiled solve through the memory rule ("auto"): prints the
    reduction the rule chose and the free memory it read, the stage split,
    the peak device memory above the resident input and the launches
    against ``want_of(impl)``.  Returns (w, z, impl, counts)."""
    from eigenexa_tpu_torch.ops import householder, kernels

    seen = {"free": None}
    free_bytes, auto_impl = householder._free_bytes, householder._auto_impl

    def read_free(dev):
        seen["free"] = free_bytes(dev)
        return seen["free"]

    def choose(x, band):
        seen["impl"] = auto_impl(x, band)
        return seen["impl"]

    householder._free_bytes, householder._auto_impl = read_free, choose
    try:
        _reset_launches(kernels)
        resident = _mem_mark(device)
        w, z, info = drive(a, profile=True)
        peak = _mem_peak(device, resident)
        counts = _take_launches(kernels)
    finally:
        householder._free_bytes, householder._auto_impl = free_bytes, \
            auto_impl
    free, impl = seen["free"], seen["impl"]
    want = want_of(impl)
    print(f"large: {label} {info.elapsed:.4f} s = {info.gflops:.2f} "
          f"GFLOP/s; the rule read {free} bytes free and chose {impl}; "
          f"peak device memory above the resident {resident} bytes: {peak} "
          f"bytes; launches {json.dumps(counts)} (expected "
          f"{json.dumps(want)})", flush=True)
    info.stage_report(lambda line: print(f"large {label} stage" + line,
                                         flush=True))
    if counts != want:
        raise AssertionError(f"large {label}: launch counts {counts}")
    return w, z, impl, counts


# torch.linalg.eigh in a process of its own: timed, not gated, and a fault
# of the library at a size it has not been run at cannot reach this one
EIGH_SCRIPT = """
import json, sys, time, torch
from eigenexa_tpu_torch.testing import frank
dev = torch.device("cuda", 0)
torch.linalg.eigh(frank(256, torch.float32, dev))
for n in map(int, sys.argv[1:]):
    a = frank(n, torch.float32, dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        w, v = torch.linalg.eigh(a)
        torch.cuda.synchronize(dev)
        out = {"seconds": time.perf_counter() - t0,
               "finite": bool(torch.isfinite(w).all()
                              & torch.isfinite(v).all())}
        del w, v
    except RuntimeError as err:
        out = {"error": str(err)[:300]}
    print("eigh", json.dumps({"n": n, "dtype": "float32", **out}),
          flush=True)
    del a
    torch.cuda.empty_cache()
"""


def eigh_times(sizes) -> None:
    """``torch.linalg.eigh`` on Frank f32 at each size, one call each after
    a small warm-up, in a child process; printed, never gated."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run([sys.executable, "-c", EIGH_SCRIPT,
                              *map(str, sizes)], cwd=here, timeout=400,
                             capture_output=True, text=True)
        lines = out.stdout.splitlines() + [
            f"exit {out.returncode} {out.stderr[-300:]!r}"] * bool(
                out.returncode)
    except subprocess.TimeoutExpired:
        lines = ["timed out after 400 s"]
    for line in lines:
        print(f"large: {line}", flush=True)


def large_phase(device, n: int = N_LARGE, eigh_sizes=(N_WINDOWED, N_LARGE)):
    """Frank n f32 through the memory rule ("auto"): eigen_s twice (the
    second bitwise equal to the first) and eigen_sx once, each with the
    checks (Z streamed in blocks of CHECK_CHUNK columns), the stage split,
    the peak device memory and the launches of the reduction the rule
    chose; then ``torch.linalg.eigh`` at `eigh_sizes`, timed.  Returns the
    launches of the first eigen_s and of the eigen_sx, and the reductions
    chosen."""
    import torch
    from eigenexa_tpu_torch import eigen_s, eigen_sx
    from eigenexa_tpu_torch.testing import frank, frank_spectrum

    a = frank(n, torch.float32, device)
    w_true = frank_spectrum(n, torch.float64)

    def want_s(impl):
        return (expected_launches_windowed(n) if impl == "windowed"
                else _want(sub_matmul=expected_launches(n)))

    w1, z1, impl_s, counts_s = _solve_large(device, eigen_s, a,
                                            f"eigen_s n={n} f32", want_s)
    _check_solution("large eigen_s", a, w1, z1, w_true, {},
                    col_chunk=CHECK_CHUNK)
    w2, z2, _, _ = _solve_large(device, eigen_s, a,
                                f"eigen_s n={n} f32 rerun", want_s)
    same = bool(torch.equal(w1, w2) and torch.equal(z1, z2))
    print(f"large: eigen_s n={n} rerun bitwise equal to the first: {same}",
          flush=True)
    if not same:
        raise AssertionError("large: the eigen_s reruns differ")
    del w1, z1, w2, z2
    _empty_cache(device)
    w, z, impl_sx, counts_sx = _solve_large(
        device, eigen_sx, a, f"eigen_sx n={n} f32",
        lambda impl: expected_launches_sx(n, impl == "windowed"))
    _check_solution("large eigen_sx", a, w, z, w_true, {},
                    col_chunk=CHECK_CHUNK)
    del a, w, z
    _empty_cache(device)
    if eigh_sizes:
        eigh_times(eigh_sizes)
    return counts_s, counts_sx, {"eigen_s": impl_s, "eigen_sx": impl_sx}


def _solve_with(device, a, impl: str, mode: str, drive=None) -> dict:
    """One profiled solve (eigen_s unless `drive` names another driver)
    with the reduction forced to `impl`: seconds, the stage split, and the
    peak device memory above what was resident before it (the input
    included in what was resident)."""
    from eigenexa_tpu_torch import eigen_s
    from eigenexa_tpu_torch.ops import householder

    old = householder.TRD_IMPL
    householder.TRD_IMPL = impl
    try:
        resident = _mem_mark(device)
        w, _, info = (drive or eigen_s)(a, mode=mode, profile=True)
        peak = _mem_peak(device, resident)
    finally:
        householder.TRD_IMPL = old
    return {"elapsed_s": info.elapsed,
            **{f"{name}_s": row["seconds"]
               for name, row in info.stages.items()},
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


def memory_phase(device, sizes=(N_SLICE, N_WINDOWED, N_LARGE)):
    """Whole-solve (mode A) peak device memory of both reductions of both
    drivers at each size, f32.  Prints bytes above the resident input and
    two constants a size: the peak with the input in n²·4 bytes, and the
    peak above what is in use when the reduction starts (the input and
    the scaled working matrix) in n²·4 bytes — the frame of
    ``householder.PEAK_N2`` and ``PEAK_MERGE``."""
    import torch
    from eigenexa_tpu_torch import eigen_sx
    from eigenexa_tpu_torch.testing import frank

    peaks = {}
    for driver in ("eigen_s", "eigen_sx"):
        for n in sizes:
            a = frank(n, torch.float32, device)
            for impl in ("rolled", "windowed"):
                run = _solve_with(device, a, impl, "A",
                                  eigen_sx if driver == "eigen_sx" else None)
                peaks[f"{driver}_{impl}_{n}"] = (
                    run["peak_bytes_above_resident"], n)
                print(f"memory: {driver} {impl} n={n} whole solve {run}",
                      flush=True)
            del a
            _empty_cache(device)
    with_input = {key: (peak + n * n * 4) / (n * n * 4)
                  for key, (peak, n) in peaks.items()}
    at_reduction = {key: (peak - n * n * 4) / (n * n * 4)
                    for key, (peak, n) in peaks.items()}
    print(f"memory: whole-solve peak above the resident input, bytes: "
          f"{json.dumps({k: p for k, (p, _) in peaks.items()})}; with the "
          f"input, in n^2*4 bytes: {json.dumps(with_input)}; above the "
          f"input and the working matrix, in n^2*4 bytes: "
          f"{json.dumps(at_reduction)}", flush=True)
    return peaks


def trd_profile(device, n: int) -> None:
    """``--trd-profile N``: torch.profiler over one reduction (mode C) of
    each implementation and each driver at Frank n f32 (``eigen_s``'s
    TRD-BLK, ``eigen_sx``'s PRD-BLK): wall seconds, device-busy seconds
    (the sum of kernel times: one stream, so they do not overlap), the
    idle share, the kernel count a column (a reflector pair for
    ``eigen_sx``) and the kernels that lead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from eigenexa_tpu_torch import eigen_s, eigen_sx
    from eigenexa_tpu_torch.ops import householder
    from eigenexa_tpu_torch.testing import frank

    a = frank(n, torch.float32, device)
    old = householder.TRD_IMPL
    drivers = (("eigen_s", eigen_s, "column",
                expected_launches_windowed(n)["symv_lower"]),
               ("eigen_sx", eigen_sx, "pair",
                expected_launches_sx(n, True)["symv_lower"]))
    try:
        for name, drive, step, steps in drivers:
            # walls of both before any profiler has run
            walls = {}
            for impl in ("rolled", "windowed", "windowed", "rolled"):
                householder.TRD_IMPL = impl
                walls.setdefault(impl, []).append(
                    drive(a, mode="C")[2].elapsed)
            for impl in ("rolled", "windowed"):
                householder.TRD_IMPL = impl
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _, _, info = drive(a, mode="C")
                events = [e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA]
                busy = sum(e.device_time_total for e in events) / 1e6
                count = sum(e.count for e in events)
                top = sorted(events, key=lambda e: -e.device_time_total)[:12]
                wall = walls[impl][1]
                print(f"trd-profile: {name} {impl} n={n} wall unprofiled "
                      f"{walls[impl]} s (cold, warm), profiled "
                      f"{info.elapsed:.4f} s, device busy {busy:.4f} s, "
                      f"idle share of the warm unprofiled wall "
                      f"{1 - busy / wall:.4f}, kernels {count} "
                      f"({count / steps:.2f} a {step} of the {steps} of "
                      f"full panels)", flush=True)
                for e in top:
                    print(f"trd-profile:   {e.device_time_total / 1e3:10.3f}"
                          f" ms {e.count:8d} x {e.key[:90]}", flush=True)
    finally:
        householder.TRD_IMPL = old


def large_window_kernels(device, chosen: dict, m: int = N_LARGE,
                         timed: bool = True):
    """Where the memory rule chose the windowed reduction at m, its kernels
    at that path's first column and panel, f32: ``symv_lower`` fused
    (eigen_s) or nc = 2 (eigen_sx), and ``rank2k_update_window``."""
    symv = ([("large_fused_first_column", m, 0, 1, True)]
            * (chosen["eigen_s"] == "windowed")
            + [("large_sx_pair_first", m, 0, 2, False)]
            * (chosen["eigen_sx"] == "windowed"))
    if not symv:
        return []
    return (symv_phase(device, m, timed, cases={"float32": symv})
            + rank2k_window_phase(device, m, timed, cases={
                "float32": [("large_first_panel", m, 0)]}))


def _kernels_line(rows, launches, complex_launches,
                  large_launches: int) -> dict:
    """One entry per kernel at its shape on the f32 windowed path, with an
    ``f64`` object of the same kernel at its shape on the f64 windowed
    path, and for ``sub_matmul`` ``c64`` and ``c128`` objects at the
    Hermitian path's first rolled panel with their launches in one eigen_h
    solve (`complex_launches`) and an ``n32768`` object at the n = 32768
    path's two f32 shapes with the launches of that eigen_s solve
    (`large_launches`); ``sturm_bisect`` (f64 only) at its band-1
    bisection of n = 8192, its plain time at n = 1024, with a ``band2``
    object of the band-2 bisection."""
    main_case = {"sub_matmul": ("wy_windowed_path", "wy"),
                 "symv_lower": ("fused_first_column",
                                "fused_f64_path_first_column"),
                 "rank2k_update_window": ("first_panel",
                                          "f64_path_first_panel")}
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    f64_keys = ("ms", "device_ms", "bound_ms", "library_ms",
                "library_device_ms", "max_abs_err")
    out = []
    for name, meta in KERNELS.items():
        if name == "sturm_bisect":
            out.append(_sturm_entry(rows, meta, launches[name]))
            continue
        row, row64 = (next(r for r in rows if r["name"] == name
                           and r["case"] == case and r["dtype"] == dtype)
                      for case, dtype in zip(main_case[name],
                                             ("float32", "float64")))
        entry = {"name": name, "route": "cuda", **meta,
                 "launches": launches[name], **{k: row[k] for k in keys},
                 "f64": {k: row64[k] for k in f64_keys}}
        if name == "sub_matmul":
            entry["n32768"] = {
                short: {"launches": large_launches,
                        **{k: r[k] for k in keys},
                        **{k: r[k] for k in ("m", "n", "k")}}
                for short, case in (("rank2k", "rank2k_large"),
                                    ("wy", "wy_large"))
                for r in rows if r["name"] == name and r["case"] == case}
            for short, dtype in (("c64", "complex64"),
                                 ("c128", "complex128")):
                crow = next(r for r in rows if r["name"] == name
                            and r["case"] == "rank2k" and r["dtype"] == dtype)
                entry[short] = {"launches": complex_launches[short],
                                **{k: crow[k] for k in keys}}
        out.append(entry)
    return {"kernels": out}


def _sturm_entry(rows, meta, launches) -> dict:
    def row(case, n):
        return next(r for r in rows if r["name"] == "sturm_bisect"
                    and r["case"] == case and r["n"] == n)

    keys = ("ms", "device_ms", "bound_ms", "library_ms", "max_abs_err")
    big, big2 = row("bisect_band1", N_F64), row("bisect_band2", N_F64)
    return {"name": "sturm_bisect", "route": "cuda", **meta,
            "launches": launches, **{k: big[k] for k in keys},
            "bound_by": big["bound_by"], "library_device_ms": None,
            "plain_ms": row("bisect_band1", N_STURM)["plain_ms"],
            "plain_ms_at_n": N_STURM, "n": N_F64,
            "band2": {**{k: big2[k] for k in keys},
                      "plain_ms": row("bisect_band2", N_STURM)["plain_ms"]}}


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

    only_kernels = sys.argv[1:2] == ["--kernels"]
    if only_kernels:
        print(_build.resource_usage(), flush=True)
    # --kernels NAME ...: the phases of the named kernels only
    names = set(sys.argv[2:] if only_kernels else ()) or set(KERNELS)
    phases = (("sub_matmul", "sub_matmul", kernel_phase, (N_SLICE, True)),
              ("sub_matmul large", "sub_matmul", large_kernel_phase, ()),
              ("same_bits", "sub_matmul", same_bits_phase, ()),
              ("sub_matmul complex", "sub_matmul", complex_kernel_phase,
               (N_SLICE, True)),
              ("symv_lower", "symv_lower", symv_phase, (N_WINDOWED, True)),
              ("rank2k_update_window", "rank2k_update_window",
               rank2k_window_phase, (N_WINDOWED, True)),
              ("sturm_bisect", "sturm_bisect", sturm_phase, ()))
    rows = []
    for label, kernel, phase, args in phases:
        if kernel in names:
            rows += _timed_phase(f"kernels {label}", phase, device, *args)
    torch.cuda.empty_cache()
    if only_kernels:
        print(gpu)
        return 0
    rolled, rolled_peak = _timed_phase("slice", slice_phase, device, N_SLICE)
    rolled64, windowed64 = _timed_phase("f64", f64_phase, device, N_F64)
    windowed, windowed_peak = _timed_phase("windowed", windowed_phase,
                                           device, N_WINDOWED)
    print(f"peak device memory of a warm solve above what was resident: "
          f"rolled n={N_SLICE} {rolled_peak} bytes, windowed "
          f"n={N_WINDOWED} {windowed_peak} bytes", flush=True)
    sx_rolled, sx_windowed = _timed_phase("sx", sx_phase, device)
    modes = _timed_phase("modes", modes_phase, device)
    herm64, herm128 = _timed_phase("hermitian", hermitian_phase, device)
    gev, gev_n = _timed_phase("gev", gev_phase, device)
    large_s, large_sx, chosen = _timed_phase("large", large_phase, device)
    rows += _timed_phase("kernels at the large windowed path",
                         large_window_kernels, device, chosen)
    paths = (("rolled", rolled), ("windowed", windowed),
             ("f64 rolled", rolled64), ("f64 windowed", windowed64),
             ("sx rolled", sx_rolled), ("sx windowed", sx_windowed),
             ("modes N and X", modes), ("hermitian c64", herm64),
             ("hermitian c128", herm128), ("gev", gev), ("gev N", gev_n),
             ("large eigen_s", large_s), ("large eigen_sx", large_sx))
    for path, counts in paths:
        print(f"launches on the {path} path: {json.dumps(counts)}",
              flush=True)
    matmul = ("sub_matmul", "symv_lower", "rank2k_update_window")
    if not (all(counts["sub_matmul"] > 0 for _, counts in paths)
            and all(path[name] > 0 for name in matmul
                    for path in (windowed, windowed64, sx_windowed))
            and modes["sturm_bisect"] > 0 and gev_n["sturm_bisect"] > 0):
        raise AssertionError("a kernel of a main path was never launched")

    print(json.dumps(_kernels_line(rows, {**windowed, "sturm_bisect":
                                          modes["sturm_bisect"]},
                                   {"c64": herm64["sub_matmul"],
                                    "c128": herm128["sub_matmul"]},
                                   large_s["sub_matmul"])))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
