"""The D&C of Frank n's reduced matrices under other chunk constants, on
one card: seconds and peak device memory of each (chunk width, panel)
pair.

For each driver (``tridiagonal``: ``solve_tridiag_dc`` on the tridiagonal
of ``tridiagonalize``; ``band2``: ``solve_band2_dc`` on the pentadiagonal
of ``band2_reduce``; both rolled, f32 vectors, as ``eigen_s`` and
``eigen_sx`` run them) the D&C runs once a pair, in the order given and
then in reverse (so a drift of the card's clock shows), with the peak
device memory above what was resident before it and whether its w and S
equal the first pair's bitwise.  Prints one ``dc_chunk`` JSON line a run
and the card's name and power limit.

    python3 tools/dc_chunk.py [n] [MIN:PANEL ...]

Run from the root of a checkout (default n = 16384 and the pairs
16384:1024, 16384:512, 16384:2048, 8192:1024).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    from eigenexa_tpu_torch import eigen_init
    from eigenexa_tpu_torch.ops import band, householder
    from eigenexa_tpu_torch.solvers import dc_band, dc_tree
    from eigenexa_tpu_torch.testing import frank

    if not torch.cuda.is_available():
        print("dc_chunk: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    eigen_init(dev)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    pairs = [tuple(map(int, p.split(":"))) for p in sys.argv[2:]] or [
        (16384, 1024), (16384, 512), (16384, 2048), (8192, 1024)]
    a = frank(n, torch.float32, dev)
    trd = householder.tridiagonalize(a, impl="rolled")
    prd = band.band2_reduce(a, impl="rolled")
    runs = (("tridiagonal", dc_tree, dc_tree.solve_tridiag_dc,
             (trd.d, trd.e)),
            ("band2", dc_band, dc_band.solve_band2_dc,
             (prd.d, prd.e1, prd.e2)))
    del a, trd, prd
    torch.cuda.empty_cache()
    for name, mod, solve, bands in runs:
        old = mod._LEVEL_CHUNK_MIN, mod._LEVEL_CHUNK_PANEL
        first = None
        try:
            for chunk_min, panel in pairs + pairs[::-1]:
                mod._LEVEL_CHUNK_MIN, mod._LEVEL_CHUNK_PANEL = chunk_min, panel
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                resident = torch.cuda.memory_allocated(dev)
                t0 = time.perf_counter()
                w, s = solve(*bands, leaf=32, vec_dtype=torch.float32)
                torch.cuda.synchronize(dev)
                seconds = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated(dev) - resident
                if first is None:
                    first = (w, s)
                same = bool(torch.equal(w, first[0])
                            and torch.equal(s, first[1]))
                print("dc_chunk", json.dumps({
                    "dc": name, "n": n, "chunk_min": chunk_min,
                    "panel": panel, "seconds": seconds,
                    "peak_bytes_above_resident": peak,
                    "bitwise_equal_to_first": same}), flush=True)
                del w, s
        finally:
            mod._LEVEL_CHUNK_MIN, mod._LEVEL_CHUNK_PANEL = old
        del first
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
