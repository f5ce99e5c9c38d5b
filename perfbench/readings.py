"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103

For each seed it builds the cell's matrix, solves it once through the
timed path (the cell's routine, mode and configuration, as the window
calls it) and prints the numbers the reference compares, one JSON line a
seed.  For each control seed it does the same with the control: the
program's own float32 path on the same matrix, the nearest precision
below the float64 that the configurations state, judged in float64's ε.
The benchmark's runs never run this; it reads a dozen seeds in one process
so that set-up is paid once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import gen, harness  # noqa: E402


def reading(spec: dict, seed: int, device, control: bool = False) -> dict:
    """One solve of the cell's matrix for ``seed`` (in float32 for the
    control) and the numbers the reference gives it."""
    import torch

    cfg, traffic = spec["config"], spec["traffic"]
    n = int(cfg["n"])
    solve, _ = harness.solver(spec, device)
    a = gen.make_matrix(traffic["matrix"], n, cfg["dtype"], seed, device)
    if control:
        a = a.float()
    t0 = time.perf_counter()
    w, z, _ = solve(a, False)
    harness._sync(device)
    wall = time.perf_counter() - t0
    del a
    a = gen.make_matrix(traffic["matrix"], n, cfg["dtype"], seed, device)
    cols = torch.randperm(n, generator=gen.generator(seed, "cpu"))
    cols = cols[:min(harness.SAMPLE_COLS, n)].sort().values.to(device)
    verdict = harness.judge(spec, a, w[None], None if z is None
                            else z.index_select(1, cols)[None], cols, w, z)
    return {"workload": spec["name"], "seed": seed,
            "kind": "control" if control else "program", "solve_s": wall,
            "correct": verdict["correct"],
            "values": {k: c["value"] for k, c in verdict["checks"].items()}}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    spec = harness.load_cell(args.workload, ROOT)
    device = torch.device("cuda:0")
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            print(json.dumps(reading(spec, seed, device, control)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
