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
which rewrites ``constexpr <type> CONST = ...;``.  ``--replace NAME OLD NEW``
adds a variant that replaces the text OLD (exactly once in the source) by
NEW: a deliberately broken copy, to show that the checks have teeth; it is
expected to exit non-zero.  Name a variant twice (first and last) to see the
run's own spread.  The full output of each variant goes to
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
                  "symv_lower.cu": ("symv_lower",)}
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
SWEEP_SIZES = {
    "--sweep": ("torch.float32", (512, 768, 1024, 1280, 1536, 1792, 2048,
                                  2304, 2560, 3072, 4096)),
    "--sweep64": ("torch.float64", (1024, 2048, 4096, 8192, 16384)),
}


def _edited(text: str, consts: dict, replace) -> str:
    for name, value in consts.items():
        text, count = re.subn(
            rf"(constexpr [\w ]+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if count != 1:
            raise SystemExit(f"constant {name}: {count} definitions found")
    if replace is not None:
        old, new = replace
        if text.count(old) != 1:
            raise SystemExit(f"text {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def _run_variant(position: int, name: str, consts: dict, replace,
                 sweep, out_dir: Path, source: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        shutil.copy(REPO / "chip_smoke.py", root)
        shutil.copytree(REPO / "eigenexa_tpu_torch",
                        root / "eigenexa_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = root / CSRC / source
        src.write_text(_edited(src.read_text(), consts, replace))
        if sweep:
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
                  if line.startswith("sweep ")), end="")
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
            kernel = re.search(r"(sub_matmul|symv)_\w*kernel\w*",
                               lines[i - 2])
            spill = lines[i - 1].strip()
            print(f"  {kernel.group(0)[:36] if kernel else '?'}: "
                  f"{line.split(':', 1)[1].strip()}; {spill}")
        if line.startswith("kernel "):
            row = json.loads(line[len("kernel "):])
            if row["name"] not in SOURCE_KERNELS[source]:
                continue
            keys = ("ms", "device_ms", "library_device_ms", "bound_ms",
                    "max_abs_err", "bitwise_equal", "bitwise_plain")
            print(f"  {row['name']} {row['case']} {row['dtype']} "
                  f"m={row['m']}: "
                  + " ".join(f"{k}={row[k]:.6g}" if isinstance(
                      row[k], float) else f"{k}={row[k]}"
                      for k in keys if k in row))


def main(argv) -> int:
    variants = []
    args = list(argv)
    sweep = args.pop(0) if args[:1] in (["--sweep"], ["--sweep64"]) else None
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
            name, old, new = args.pop(0), args.pop(0), args.pop(0)
            variants.append((name, {}, (old, new)))
            continue
        name, _, spec = arg.partition(":")
        consts = dict(item.split("=", 1) for item in spec.split(",") if item)
        variants.append((name, consts, None))
    if not variants:
        print(__doc__)
        return 2
    for position, (name, consts, replace) in enumerate(variants):
        _run_variant(position, name, consts, replace, sweep, out_dir,
                     source)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
