"""The backward error of the reductions of a Frank matrix, apart from the
D&C, on one card.

For each reduction the eigenvalues of the reduced matrix (``eigvalsh`` in
f64) are held against the analytic Frank spectrum as w_scaled =
max|w − w*| / (ε·‖A‖₂), ε of the solve's dtype:

* ``band2_rolled``: ``band2_reduce`` rolled, as shipped (B·V of a
  reflector pair as two matvecs);
* ``band2_rolled_product``: the same with B·V as one two-column product
  (``b @ v_pair``), the form the JAX package writes;
* ``band2_windowed``: ``band2_reduce`` windowed (``symv_lower`` nc = 2);
* ``tridiagonal_rolled``, ``tridiagonal_windowed``: ``tridiagonalize``.

Then the residual of each D&C on its own reduced matrix (the reference's
residual check, f64): ``dc_band2`` on the rolled pentadiagonal,
``dc_tridiagonal`` on the rolled tridiagonal.  Prints one JSON line with
the card's name and power limit.

    python3 tools/band_accuracy.py [n] [float32|float64]

Run from the root of a checkout (default n = 8192, float32).
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _one_product(b, v_pair):
    """B·V of a reflector pair as one two-column product."""
    return b @ v_pair


def main() -> int:
    import torch
    from eigenexa_tpu_torch import eigen_init
    from eigenexa_tpu_torch.ops import band, householder
    from eigenexa_tpu_torch.solvers import dc, dc_band
    from eigenexa_tpu_torch.testing import (frank, frank_spectrum,
                                            residual_check)

    if not torch.cuda.is_available():
        print("band_accuracy: needs a CUDA device", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    dtype = getattr(torch, sys.argv[2] if len(sys.argv) > 2 else "float32")
    dev = torch.device("cuda")
    eigen_init(dev)
    a = frank(n, dtype, dev)
    w_true = frank_spectrum(n, torch.float64, dev)
    scale = torch.finfo(dtype).eps * float(w_true.abs().max())

    def w_scaled(d, *offd):
        t = band.assemble_band2(d, offd[0], offd[1]) if len(offd) == 2 \
            else dc.assemble_tridiag(d, offd[0])
        w = torch.linalg.eigvalsh(t.to(torch.float64))
        return float((w - w_true).abs().max()) / scale

    out = {"n": n, "dtype": str(dtype).split(".")[1]}
    rolled = band.band2_reduce(a, impl="rolled")
    out["band2_rolled"] = w_scaled(rolled.d, rolled.e1, rolled.e2)
    shipped = band._two_matvecs
    band._two_matvecs = _one_product
    try:
        red = band.band2_reduce(a, impl="rolled")
    finally:
        band._two_matvecs = shipped
    out["band2_rolled_product"] = w_scaled(red.d, red.e1, red.e2)
    red = band.band2_reduce(a, impl="windowed")
    out["band2_windowed"] = w_scaled(red.d, red.e1, red.e2)
    trd = householder.tridiagonalize(a, impl="rolled")
    out["tridiagonal_rolled"] = w_scaled(trd.d, trd.e)
    red = householder.tridiagonalize(a, impl="windowed")
    out["tridiagonal_windowed"] = w_scaled(red.d, red.e)
    del red

    bands = [x.to(torch.float64) for x in (rolled.d, rolled.e1, rolled.e2)]
    w, s = dc_band.solve_band2_dc(*bands, vec_dtype=torch.float64)
    out["dc_band2_residual"] = residual_check(
        band.assemble_band2(*bands), s, w).value
    tri = [x.to(torch.float64) for x in (trd.d, trd.e)]
    w, s = dc.solve_tridiag(*tri, vec_dtype=torch.float64)
    out["dc_tridiagonal_residual"] = residual_check(
        dc.assemble_tridiag(*tri), s, w).value
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
