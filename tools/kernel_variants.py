"""Time variants of a kernel source side by side on one card, in one run.

Two builds of a kernel compare only within one run on one card, so this
script makes each variant as a copy of the port (``chip_smoke.py`` and
``eigenexa_tpu_torch/``) in a temporary directory, edits the copy's
``csrc/sub_matmul.cu`` (or, after ``--source symv_lower.cu``, that
source), runs ``python3 chip_smoke.py --kernels`` there (its own build, its
own checks) and prints, for each variant, the exit code, ptxas's line for
every kernel of the edited source, and one short line per ``kernel`` case
of the kernels of that source, f32 and f64.  The checkout itself is never
edited.

    python3 tools/kernel_variants.py base slice16:kBigSlice=16 \\
        rule1:kBigTilesPerSm=1 base

A variant is ``name`` (the source as it is) or ``name:CONST=VALUE[,...]``,
which rewrites ``constexpr <type> CONST = ...;``; ``name@FILE`` takes FILE
as the source (an older version of it, with the same entry points).
``--replace NAME[:CONST=VALUE,...] OLD NEW`` adds a variant that replaces
the text OLD (exactly once in the source) by NEW, with the constants
rewritten too; ``--replace`` again with the same NAME adds a replacement to
that variant.  A deliberately broken copy shows that the checks have teeth
(it is expected to exit non-zero); a copy with a part taken out, timed by a
sweep, shows what that part costs.  Name a variant twice (first and last)
to see the run's own spread.  The full output of each variant goes to
``<out>/variant_<position>_<name>.txt``; ``--out DIR`` before the variants
names the directory (default ``build/variants``).

``--source NAME`` (before ``--out``) picks the source under ``csrc/``
that the variants edit.  ``--sweep`` as the first argument runs, in place of
``chip_smoke.py --kernels``, a sweep over f32 squares m = 512 ... 4096 at
k = 128, in place: 50 launches between two CUDA events, the median of 7
such batches, so that the host's launch overhead does not hide a kernel of
50 microseconds.  With one variant that sends every f32 launch to the
128-tile kernel (``kBigTilesPerSm=0``) and one that sends none
(``=100000``) it shows where the launch rule should cross.  ``--sweep64``
does the same over f64 squares m = 1024 ... 16384; it checks nothing, so
it also times copies that leave out a part of the kernel on purpose.
``--sweep-complex`` times c64 and c128 squares m = 64 ... 8192 at k = 128
in place the same way, beside ``torch.addmm(b, p, q.conj().T, alpha=-1)``,
each also as ``graph_ms``: 20 calls captured in a CUDA graph and replayed
(median of 7), the card's time without the host's, which below m = 1024
hides the kernel in ``ms``; with a digest of one call's bits, and at the
largest the SM clock and the power drawn under each (``nvidia-smi``); with
one variant that sends every complex launch to the larger-tile kernels
(``kC2TilesPerSm=0,kZ2TilesPerSm=0``) and one that sends none
(``=100000``) it places the complex launch rules, and the digests show
that both kernels of a type give the same bits.  ``--sweep-sturm`` (with
``--source sturm.cu``) times ``sturm_bisect`` at Frank n = 8192,
bisection and refinement, band 1 and 2, and prints a digest of each
result's bits, which all correct variants share:

    python3 tools/kernel_variants.py --sweep-sturm --source sturm.cu \\
        old@build/sturm_old.cu L2:kLevelsBand1=2,kLevelsBand2=2 base
"""

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = Path("eigenexa_tpu_torch") / "csrc"
SOURCE_KERNELS = {"sub_matmul.cu": ("sub_matmul", "rank2k_update_window"),
                  "symv_lower.cu": ("symv_lower",),
                  "sturm.cu": ("sturm_bisect",)}
SWEEP = """
import statistics, torch
from eigenexa_tpu_torch.ops import kernels
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(5)
for m in SIZES:
    b, p, q = (torch.randn(m, c, generator=gen, device=dev, dtype=DTYPE)
               * 1e-3 for c in (m, 128, 128))
    kernels.sub_matmul(b, p, q, out=b)
    times = []
    for _ in range(7):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(50):
            kernels.sub_matmul(b, p, q, out=b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 50)
    tiles = (-(-m // 128)) ** 2
    print(f"sweep {DTYPE} m={m} tiles128={tiles} "
          f"ms={statistics.median(times):.5f} min={min(times):.5f}",
          flush=True)
"""
# complex squares at k = 128, after what ptxas reports for the source:
# first the bits of one call out of place (a digest, which every correct
# variant shares: the kernels of a launch rule give the same bits), then in
# place as SWEEP times, and torch.addmm on the same operands (the library's
# time, alike in every variant)
COMPLEX_SWEEP = """
import hashlib, statistics, subprocess, torch
from eigenexa_tpu_torch.ops import _build, kernels
dev = torch.device("cuda", 0)
print(_build.resource_usage(("sub_matmul.cu",)), flush=True)
def device_ms(fn):
    fn()
    times = []
    for _ in range(7):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(50):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 50)
    return statistics.median(times)
def graph_ms(fn, reps=20):
    # the same calls captured in a CUDA graph: the card's time without the
    # host's, which hides small launches in device_ms
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(7):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)
for dtype in (torch.complex64, torch.complex128):
    gen = torch.Generator(device=dev).manual_seed(5)
    for m in SIZES:
        b, p, q = (torch.randn(m, c, generator=gen, device=dev, dtype=dtype)
                   * 1e-3 for c in (m, 128, 128))
        bits = kernels.sub_matmul(b, p, q)
        sha = hashlib.sha256(
            torch.view_as_real(bits).cpu().numpy().tobytes()).hexdigest()
        del bits
        ms = device_ms(lambda: kernels.sub_matmul(b, p, q, out=b))
        lib = device_ms(lambda: torch.addmm(b, p, q.conj().T, alpha=-1,
                                            out=b))
        graph = graph_ms(lambda: kernels.sub_matmul(b, p, q, out=b))
        lib_graph = graph_ms(lambda: torch.addmm(b, p, q.conj().T,
                                                 alpha=-1, out=b))
        clocks = ""
        if m == SIZES[-1]:
            # the SM clock and the power drawn while a second of the kernel
            # (then of the library call) is queued, so that the reading
            # falls inside it
            for name, fn, t in (("kernel", lambda: kernels.sub_matmul(
                    b, p, q, out=b), ms), ("addmm", lambda: torch.addmm(
                    b, p, q.conj().T, alpha=-1, out=b), lib)):
                for _ in range(int(1000 / t)):
                    fn()
                clocks += f" {name}_clock_power=" + subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip().replace(" ", "")
                torch.cuda.synchronize()
        print(f"sweep {dtype} m={m} ms={ms:.5f} addmm_ms={lib:.5f} "
              f"graph_ms={graph:.5f} addmm_graph_ms={lib_graph:.5f} "
              f"sha={sha[:16]}{clocks}", flush=True)
"""
# sturm_bisect on the bands of Frank n's reductions, the operands of modes N
# and X: bisection (70 steps) and refinement (45 and the valid check, w0 the
# library's eigenvalues with index n // 3 pushed out), band 1 and 2; device
# time as chip_smoke's (3 launches between two events, median of 3), and a
# digest of the bits, which every correct variant shares; first what ptxas
# reports for the source.  The bands and w0 are made once and kept in BANDS
# for the variants that follow.
STURM_SWEEP = """
import hashlib, json, os, torch
import chip_smoke as cs
from eigenexa_tpu_torch.ops import _build, kernels, sturm
dev = torch.device(DEV)
if dev.type == "cuda":
    print(_build.resource_usage(("sturm.cu",)), flush=True)
if os.path.exists(BANDS):
    kept = torch.load(BANDS)
else:
    kept = {}
    for b, (d, e1, e2) in cs.frank_bands(dev, N).items():
        dense = torch.diag(d) + torch.diag(e1, 1) + torch.diag(e1, -1)
        if e2 is not None:
            dense += torch.diag(e2, 2) + torch.diag(e2, -2)
        w0 = torch.linalg.eigvalsh(dense)
        w0[N // 3] += 10.0 * float(w0.abs().max())
        kept[b] = [None if x is None else x.cpu() for x in (d, e1, e2, w0)]
    torch.save(kept, BANDS)
for b, host in sorted(kept.items()):
    d, e1, e2, w0 = (None if x is None else x.to(dev) for x in host)
    for op, n_iter, valid in (("bisect", 70, False), ("refine", 45, True)):
        ends = (sturm.refine_brackets(w0) if valid
                else sturm.bisect_brackets(d, e1, e2))
        args = (d, e1, e2, *ends, n_iter, valid, w0)
        w = kernels.sturm_bisect(*args).cpu()
        row = {"case": f"{op}_band{b}", "n": N,
               "sha": hashlib.sha256(w.numpy().tobytes()).hexdigest()[:16],
               "kept_w0": not valid or float(w[N // 3]) == float(w0[N // 3])}
        if dev.type == "cuda":
            row["device_ms"] = cs._device_ms(
                lambda: kernels.sturm_bisect(*args), dev, 3, 3)
        print("sturm " + json.dumps(row), flush=True)
"""
SWEEP_SIZES = {
    "--sweep": ("torch.float32", (512, 768, 1024, 1280, 1536, 1792, 2048,
                                  2304, 2560, 3072, 4096)),
    "--sweep64": ("torch.float64", (1024, 2048, 4096, 8192, 16384)),
    "--sweep-complex": (None, (64, 128, 192, 256, 384, 512, 576, 640, 704,
                               768, 896, 1024, 1280, 1536, 2048, 3072, 4096,
                               8128, 8192)),
}


def _edited(text: str, consts: dict, replace) -> str:
    for name, value in consts.items():
        text, count = re.subn(
            rf"(constexpr [\w ]+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if count != 1:
            raise SystemExit(f"constant {name}: {count} definitions found")
    for old, new in replace or ():
        if text.count(old) != 1:
            raise SystemExit(f"text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def _run_variant(position: int, name: str, consts: dict, replace, path,
                 sweep, out_dir: Path, source: str, work: Path) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        shutil.copy(REPO / "chip_smoke.py", root)
        shutil.copytree(REPO / "eigenexa_tpu_torch",
                        root / "eigenexa_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = root / CSRC / source
        text = (path or src).read_text()
        src.write_text(_edited(text, consts, replace))
        if sweep == "--sweep-sturm":
            command = ["-c", f"DEV = 'cuda'\nN = 8192\n"
                       f"BANDS = {str(work / 'sturm_bands.pt')!r}\n"
                       f"{STURM_SWEEP}"]
        elif sweep == "--sweep-complex":
            command = ["-c", f"SIZES = {SWEEP_SIZES[sweep][1]}\n"
                       f"{COMPLEX_SWEEP}"]
        elif sweep:
            dtype, sizes = SWEEP_SIZES[sweep]
            command = ["-c", f"import torch\nDTYPE = {dtype}\n"
                       f"SIZES = {sizes}\n{SWEEP}"]
        else:
            command = ["chip_smoke.py", "--kernels",
                       *SOURCE_KERNELS[source]]
        proc = subprocess.run([sys.executable, *command], cwd=root,
                              capture_output=True, text=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"variant_{position}_{name}.txt").write_text(
        proc.stdout + proc.stderr)
    print(f"variant {name} {json.dumps(consts)} replace="
          f"{replace is not None}: exit {proc.returncode}", flush=True)
    _print_summary(proc.stdout, source)
    print("".join(f"  {line}\n" for line in proc.stdout.splitlines()
                  if line.startswith(("sweep ", "sturm "))), end="")
    if proc.returncode != 0:
        tail = (proc.stderr.strip().splitlines() or ["(no stderr)"])[-1]
        print(f"  failed with: {tail[:600]}")


def _print_summary(stdout: str, source: str) -> None:
    """ptxas's figures for the edited source, and its kernel cases."""
    lines = stdout.splitlines()
    in_source = False
    for i, line in enumerate(lines):
        if line.startswith("resource usage of "):
            in_source = source in line
        if in_source and "Used" in line and "registers" in line:
            kernel = re.search(
                r"(?<=\d)(sub_matmul_kernel|symv_\w*?kernel|sturm_bisect_"
                r"kernel)\w*?(?=E)", lines[i - 2])
            spill = lines[i - 1].strip()
            print(f"  {kernel.group(0)[:40] if kernel else '?'}: "
                  f"{line.split(':', 1)[1].strip()}; {spill}")
        if line.startswith("kernel "):
            row = json.loads(line[len("kernel "):])
            if row["name"] not in SOURCE_KERNELS[source]:
                continue
            keys = ("ms", "device_ms", "library_device_ms", "bound_ms",
                    "max_abs_err", "bitwise_equal", "bitwise_plain")
            print(f"  {row['name']} {row['case']} {row['dtype']} "
                  f"m={row.get('m', row.get('n'))}: "
                  + " ".join(f"{k}={row[k]:.6g}" if isinstance(
                      row[k], float) else f"{k}={row[k]}"
                      for k in keys if k in row))


def main(argv) -> int:
    variants = []
    args = list(argv)
    sweep = (args.pop(0) if args[:1] in (["--sweep"], ["--sweep64"],
                                         ["--sweep-complex"],
                                         ["--sweep-sturm"]) else None)
    source = "sub_matmul.cu"
    if args[:1] == ["--source"]:
        source = args[1]
        del args[:2]
    if source not in SOURCE_KERNELS:
        raise SystemExit(f"--source: one of {sorted(SOURCE_KERNELS)}")
    out_dir = REPO / "build" / "variants"
    if args[:1] == ["--out"]:
        out_dir = Path(args[1]).resolve()
        del args[:2]
    while args:
        arg = args.pop(0)
        if arg == "--replace":
            spec, old, new = args.pop(0), args.pop(0), args.pop(0)
            name, _, consts = spec.partition(":")
            same = [v for v in variants if v[0] == name and v[2]]
            if same:
                same[0][2].append((old, new))
            else:
                variants.append((name, dict(
                    item.split("=", 1) for item in consts.split(",")
                    if item), [(old, new)], None))
            continue
        name, _, spec = arg.partition(":")
        name, _, path = name.partition("@")
        consts = dict(item.split("=", 1) for item in spec.split(",") if item)
        variants.append((name, consts, None,
                         Path(path).resolve() if path else None))
    if not variants:
        print(__doc__)
        return 2
    with tempfile.TemporaryDirectory() as work:
        for position, (name, consts, replace, path) in enumerate(variants):
            _run_variant(position, name, consts, replace, path, sweep,
                         out_dir, source, Path(work))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
