"""Time `symv_lower` and the windowed reduction of two trees in one run.

Two versions of a kernel compare only within one run on one card.  This
script runs, in turns OLD, NEW, NEW, OLD, one process per turn in the root
of each tree (its own build, its own ``eigenexa_tpu_torch``), and each turn
prints one JSON line:

* ``symv``: each case of ``symv_lower(b, x, t0=t0)``, the form both trees
  take: ``ms`` (one call with its host side), ``device_ms`` (50 launches
  between two events, the median of 5 runs, over 50) and ``torch.mv``'s
  device time on the window square; where the tree's ``symv_lower`` takes a
  panel, also the fused form as the windowed column calls it, into a
  workspace;
* ``trd``: ``eigen_s(frank(n), mode="C", profile=True)`` with the windowed
  reduction forced, its TRD-BLK seconds, at n = 16384 f32 and n = 8192 f64;
* ``per_column``: the device kernels of one windowed reduction at n = 8192
  f32 (``torch.profiler``), over its columns of full panels.

    python3 tools/old_new.py build/parent            # OLD; NEW is this tree
    python3 tools/old_new.py build/parent --quick    # symv only

The timing helpers are ``chip_smoke.py``'s, loaded from this tree.  Make
OLD with ``git archive <commit> | tar -x -C build/parent``.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

TURN = r"""
import importlib.util, inspect, json, sys, time
import torch
spec = importlib.util.spec_from_file_location("cs", SMOKE)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from eigenexa_tpu_torch.ops import _build, householder, kernels
from eigenexa_tpu_torch import eigen_s
from eigenexa_tpu_torch.testing import frank

dev = torch.device("cuda", 0)
t = time.perf_counter()
_build.load_library()
out = {"tree": TREE, "build_s": time.perf_counter() - t, "symv": []}
fused = "panel" in inspect.signature(kernels.symv_lower).parameters
gen = torch.Generator(device=dev).manual_seed(17)
CASES = [("float32", 16384, 0), ("float32", 16384, 16), ("float32", 16384, 28),
         ("float64", 16384, 0), ("float64", 16384, 16),
         ("float64", 8192, 0), ("float64", 8192, 8)]
for name, m, t0 in CASES:
    dtype = getattr(torch, name)
    w0 = t0 * kernels.WIN_TM
    b = torch.randn(m, m, generator=gen, dtype=dtype, device=dev)
    x = torch.randn(m, generator=gen, dtype=dtype, device=dev)
    win, xw = b[w0:, w0:], x[w0:]
    row = {"dtype": name, "m": m, "t0": t0,
           "ms": cs._time_ms(lambda: kernels.symv_lower(b, x, t0=t0), dev),
           "device_ms": cs._device_ms(
               lambda: kernels.symv_lower(b, x, t0=t0), dev),
           "mv_device_ms": cs._device_ms(lambda: torch.mv(win, xw), dev)}
    if fused:
        nb = cs.NB_F - 1
        uw = torch.zeros(m, 2 * cs.NB_F, dtype=dtype, device=dev)
        uw[w0:, :nb] = 0.01
        uw[w0:, cs.NB_F:cs.NB_F + nb] = 0.01
        ws = kernels.symv_workspace(b, panel_cols=2 * cs.NB_F)
        call = lambda: kernels.symv_lower(b, x, t0=t0, panel=uw, nb=nb, **ws)
        row["fused_ms"] = cs._time_ms(call, dev)
        row["fused_device_ms"] = cs._device_ms(call, dev)
        del uw, ws
    row.update(cs._bound(name, (m - w0) * (m - w0 + 1) / 2 + 2 * m,
                         2.0 * (m - w0) ** 2))
    out["symv"].append(row)
    del b, x, win, xw
torch.cuda.empty_cache()
if not QUICK:
    householder.TRD_IMPL = "windowed"
    out["trd"] = {}
    for name, n in (("float32", 16384), ("float64", 8192)):
        a = frank(n, getattr(torch, name), dev)
        info = eigen_s(a, mode="C", profile=True)[2]
        out["trd"][f"{name}_{n}"] = {
            "elapsed_s": info.elapsed,
            "trd_blk_s": info.stages["TRD-BLK"]["seconds"]}
        del a
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = 8192
    a = frank(n, torch.float32, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eigen_s(a, mode="C")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    count = sum(e.count for e in events)
    columns = cs.expected_launches_windowed(n)["symv_lower"]
    out["per_column"] = {
        "n": n, "kernels": count, "columns": columns,
        "kernels_per_column": count / columns,
        "device_busy_s": sum(e.device_time_total for e in events) / 1e6,
        "symv_kernels_ms": {e.key[:60]: e.device_time_total / 1e3
                            for e in events if "symv" in e.key}}
print("old_new " + json.dumps(out), flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    old = Path(argv[0]).resolve()
    quick = "--quick" in argv[1:]
    rc = 0
    for label, tree in (("old", old), ("new", REPO), ("new", REPO),
                        ("old", old)):
        code = (f"SMOKE = {str(REPO / 'chip_smoke.py')!r}\n"
                f"TREE = {label!r}\nQUICK = {quick}\n" + TURN)
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(f"turn {label} failed: {proc.stderr[-3000:]}", flush=True)
            rc = 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
