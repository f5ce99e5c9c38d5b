"""Count the FP64 instructions of one Sturm step in the built kernel, and
the issue bound of ``sturm_bisect`` that follows from them.

``chip_smoke.py``'s ``bound_ms`` for ``sturm_bisect`` counts the
recurrence's f64 operations (5 a band-1 step, 12 a band-2 step) at the
34 TFLOP/s FP64 peak.  That peak counts an FMA as two operations, and a
``__ddiv_rn`` is a sequence of instructions, not one operation.  This
script compiles ``csrc/sturm.cu`` for sm_90a into a cubin, disassembles it
with ``cuobjdump -sass``, and, for each instance of the kernel, finds the
innermost loops that hold a ``MUFU.RCP64H`` (the start of a division): the
step loop of the recurrence, unrolled or not.  A step holds one division in
band 1 and two in band 2, so the loop's steps are its ``MUFU.RCP64H``s over
that, and its FP64 pipe instructions (``DADD``, ``DMUL``, ``DFMA``,
``DSETP``, ``DSET``, ``DMNMX``) over its steps are a step's.  The issue
bound is then the work over the card's FP64 issue rate, 132 SMs x 64 FP64
lanes x 1.98 GHz = 16.7e12 lane instructions a second:

* ``issue_bound_ms``: bisection's own work, n (n_iter + 2 with the valid
  check) counts of n steps;
* ``issued_at_peak_ms``: the work the kernel issues, n 2^L threads, one
  count a round of L levels (and one for the valid check).

    python3 tools/sturm_sass.py [n] [--sass FILE]    # n = 8192 by default

Prints one ``sass {json}`` line per kernel instance and one ``issue
{json}`` line per case (bisection of 70 steps, refinement of 45 with the
valid check; band 1 and 2); ``--sass FILE`` also writes the whole
disassembly there.  Needs ``nvcc`` and ``cuobjdump``; no card.
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "eigenexa_tpu_torch" / "csrc" / "sturm.cu"
FP64_LANE_INSTR_PER_S = 132 * 64 * 1.98e9   # lane instructions a second
FP64_PIPE = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
DIVISIONS = {1: 1, 2: 2}               # divisions a step, per band
CASES = (("bisect", 70, False), ("refine", 45, True))


def _tool(name: str) -> str:
    """nvcc's neighbour `name` in the toolkit that builds the kernels."""
    sys.path.insert(0, str(REPO))
    from eigenexa_tpu_torch.ops import _build

    return str(Path(_build._nvcc()).with_name(name))


def disassemble() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "sturm.cubin"
        subprocess.run([_tool("nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-cubin", "-o", str(cubin), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        return subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              check=True, capture_output=True,
                              text=True).stdout


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, text)]}"""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and current is not None:
            text = m.group(2).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            current.append((int(m.group(1), 16), op, text))
    return out


def innermost_division_loops(code):
    """[(first address, last address)] of the loops (a backward branch and
    its target) that hold a MUFU.RCP64H and no other loop."""
    loops = []
    for addr, op, text in code:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi)
                        for lo2, hi2 in loops)]
    return [(lo, hi) for lo, hi in inner
            if any(lo <= a <= hi and op == "MUFU.RCP64H"
                   for a, op, _ in code)]


def step_counts(code, band: int) -> list:
    rows = []
    for lo, hi in innermost_division_loops(code):
        body = [op for a, op, _ in code if lo <= a <= hi]
        steps = body.count("MUFU.RCP64H") / DIVISIONS[band]
        fp64 = sum(op.split(".")[0] in FP64_PIPE for op in body)
        rows.append({"loop": [hex(lo), hex(hi)], "steps": steps,
                     "fp64_instructions": fp64,
                     "fp64_per_step": fp64 / steps,
                     "instructions_per_step": len(body) / steps,
                     "by_opcode": {k: sum(op.split(".")[0] == k
                                          for op in body)
                                   for k in sorted(FP64_PIPE)
                                   if k in {o.split(".")[0] for o in body}}})
    return rows


def main(argv) -> int:
    args = list(argv)
    sass_file = None
    if "--sass" in args:
        at = args.index("--sass")
        sass_file = Path(args[at + 1])
        del args[at:at + 2]
    n = int(args[0]) if args else 8192
    sass = disassemble()
    if sass_file is not None:
        sass_file.parent.mkdir(parents=True, exist_ok=True)
        sass_file.write_text(sass)
    levels = {band: int(re.search(rf"constexpr int kLevelsBand{band} = "
                                  r"(\d+);", SOURCE.read_text()).group(1))
              for band in (1, 2)}
    per_step = {}
    for name, code in functions(sass).items():
        m = re.search(r"sturm_bisect_kernelILb([01])ELi(\d)E", name)
        if not m:
            continue
        band, kl = int(m.group(1)) + 1, int(m.group(2))
        rows = step_counts(code, band)
        print("sass " + json.dumps({"kernel": name, "band": band, "L": kl,
                                    "loops": rows}), flush=True)
        if kl == levels[band] and rows:
            # the loop that runs the most steps a pass: the unrolled body
            per_step[band] = max(rows, key=lambda r: r["steps"])
    for band, row in sorted(per_step.items()):
        kl, f = levels[band], row["fp64_per_step"]
        for op, n_iter, valid in CASES:
            counts = n * (n_iter + 2 * valid)
            issued = n * 2 ** kl * (-(-n_iter // kl) + valid)
            print("issue " + json.dumps({
                "case": f"{op}_band{band}", "n": n, "n_iter": n_iter,
                "L": kl, "fp64_per_step": f,
                "issue_bound_ms": counts * n * f / FP64_LANE_INSTR_PER_S * 1e3,
                "issued_at_peak_ms": issued * n * f / FP64_LANE_INSTR_PER_S
                * 1e3}), flush=True)
    return 0 if len(per_step) == 2 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
