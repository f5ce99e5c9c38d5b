"""The port's band-2 stages against the plain reference
(``eigenexa_tpu_torch/testing/plain_band2.py``) on the benchmark's own
matrices, on one card.  Nothing here imports JAX.

For each seed it makes the matrix of the cell ``eigen_sx-f64-n8192.A-random``
(``perfbench/gen.py``: U(0,1) + transpose, float64) at order n and prints one
JSON line:

* ``bands``: max|x − x_plain| / (ε·‖A‖₂) of the port's ``band2_reduce``
  (rolled, as the cell runs it) against the unblocked reduction, for d,
  |e1| and |e2|; ``bands_f32`` the same for the port's float32 reduction
  of the same matrix.  Tolerance 10·n, as ``tests/test_torch_sx_plain.py``
  holds the bands: both reductions are backward stable, but the last
  entries of a reduction are sensitive to rounding in all the reflectors
  before them (up to 4.1·n over 31 seeds at n = 300 on the CPU, as far as
  the port's own rolled and windowed reductions drift apart), while the
  float32 reduction must miss 10·n by 10³ or more;
* ``spectrum``: the w_gap (max|w − w_ref| / (ε·max|w_ref|), as the
  benchmark's reference reads it) of the eigenvalues of the port's P, of
  the plain P and of the float32 P against ``eigvalsh(A)``; tolerance the
  cell's ``w_gap`` limit (``perfbench/limits``);
* ``dc``: the port's ``solve_band2_dc`` on the port's bands against
  ``eigvalsh`` of the dense P (w_gap, tolerance 10·n: a D&C's backward
  error), and its vectors' residual ‖PS − SW‖_F / (n·ε·‖P‖_F) and
  orthogonality ‖SᵀS − I‖_F / (n·ε) against 768 and 8.

    python3 tools/band2_plain.py [--n 8192] --seeds 1 2 ...

Run from the root of a checkout on a machine with a card (``--device cpu``
with a small n runs it here).  ε is float64's.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELL = "eigen_sx-f64-n8192.A-random"
RESIDUAL, ORTHOGONALITY = 768.0, 8.0


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def check(n: int, seed: int, device) -> dict:
    import torch

    from eigenexa_tpu_torch.ops import band
    from eigenexa_tpu_torch.solvers.dc_band import solve_band2_dc
    from eigenexa_tpu_torch.testing import plain_band2
    from perfbench import gen

    f64 = torch.float64
    eps = torch.finfo(f64).eps
    limits = json.loads((ROOT / "perfbench" / "limits"
                         / f"{CELL}.json").read_text())
    a = gen.make_matrix({"kind": "random_symmetric"}, n, "float64", seed,
                        device)
    times = {}

    def timed(name, fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = time.perf_counter() - t0
        return out

    w_ref = timed("eigvalsh_a", lambda: torch.linalg.eigvalsh(a))
    norm = float(w_ref.abs().amax())
    port = timed("port_f64", lambda: band.band2_reduce(a, impl="rolled"))
    port32 = timed("port_f32", lambda: band.band2_reduce(a.float(),
                                                         impl="rolled"))
    plain = timed("plain", lambda: plain_band2.band2_reduce(a))
    del a

    def gaps(red):
        got = (red.d.to(f64), red.e1.to(f64).abs(), red.e2.to(f64).abs())
        want = (plain[0], plain[1].abs(), plain[2].abs())
        return {k: float((x - y).abs().amax()) / (eps * norm)
                for k, x, y in zip(("d", "e1", "e2"), got, want)}

    def w_gap(w, ref, scale):
        return float((w.to(f64) - ref).abs().amax()) / (eps * scale)

    bands, bands32 = gaps(port), gaps(port32)
    same_sign = {k: float((torch.sign(getattr(port, k)) == torch.sign(
        x)).double().mean()) for k, x in (("e1", plain[1]), ("e2", plain[2]))}
    w_port = plain_band2.band2_eigvalsh(port.d, port.e1, port.e2)
    spectrum = {
        "port": w_gap(w_port, w_ref, norm),
        "plain": w_gap(plain_band2.band2_eigvalsh(*plain), w_ref, norm),
        "port_f32": w_gap(plain_band2.band2_eigvalsh(
            port32.d, port32.e1, port32.e2), w_ref, norm)}
    del port32, plain
    w_dc, s = timed("dc", lambda: solve_band2_dc(port.d, port.e1, port.e2))
    p = plain_band2.assemble(port.d, port.e1, port.e2)
    torch.backends.cuda.matmul.allow_tf32 = False
    residual = float(torch.linalg.vector_norm(p @ s - s * w_dc[None, :])) / (
        n * eps * float(torch.linalg.vector_norm(p)))
    gram = s.T @ s
    gram.diagonal().sub_(1.0)
    orth = float(torch.linalg.vector_norm(gram)) / (n * eps)
    dc = {"w_gap": w_gap(w_dc, w_port, float(w_port.abs().amax())),
          "residual": residual, "orthogonality": orth}
    w_limit = limits["w_gap"]["limit"]
    passed = (all(v <= 10 * n for v in bands.values())
              and all(v > 1e4 * n for v in bands32.values())
              and spectrum["port"] <= w_limit
              and spectrum["port_f32"] > 1e3 * w_limit
              and dc["w_gap"] <= 10 * n and residual < RESIDUAL
              and orth < ORTHOGONALITY)
    return {"seed": seed, "n": n, "bands": bands, "bands_f32": bands32,
            "bands_tol": 10 * n, "same_sign": same_sign, "spectrum": spectrum,
            "w_gap_limit": w_limit, "dc": dc, "dc_w_tol": 10 * n,
            "passed": passed, "seconds": times}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    import torch

    device = torch.device(args.device)
    card = _card() if device.type == "cuda" else "cpu"
    ok = True
    for seed in args.seeds:
        line = check(args.n, seed, device)
        line["card"] = card
        ok &= line["passed"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
