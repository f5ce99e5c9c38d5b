"""pair_update_roofline: the hand-written ``pair_update`` kernels' share of
their roofline over one profiled solve, %: the sum of each call's bound
time over the sum of the device time of its three kernels (the slabs'
sums of Wᵀ·V and Uᵀ·V, the rows of P, the stores).

The launches are enumerated from n and the panel width of ``eigen_sx``'s
band-2 reduction (``ops/band.py``): one a reflector pair, nb/2 a panel
while more than nb + 2 rows are live, then every pair of the remainder's
m rows padded to an even m + 2 or m + 3.  The pair at c0 has c0 earlier
columns of U and W; a pair of the rolled reduction has the live block's
rows, one of the windowed reduction all n (it ran where the profiled solve
launched ``symv_lower``).  The enumeration has to match the program's own
count of launches (``kernels.LAUNCHES``) over the profiled solve, or the
run fails: the bound would be of other work than timed.

A call's bound (``peaks.bound_s``) with m rows and c0 earlier columns:
U's and W's earlier columns, B·V and V read once, the pair's four new
columns written once, and T, 2·m·c0 + 8·m + 4 elements; against its real
operations, 16·m·c0 + 20·m (Wᵀ·V and Uᵀ·V, then U and W against them, then
P, Vᵀ·P and the new columns); the second kernel reads U and W again, from
L2, which the bound does not count."""

from perfbench.peaks import bound_s

KERNELS = ("pair_update_dots", "pair_update_rows",   # csrc/householder.cu
           "pair_update_store")


def launch_shapes(rec) -> list:
    """(m, c0) of every ``pair_update`` launch of one solve, in order."""
    cfg, n = rec["config"], rec["n"]
    if cfg["routine"] != "eigen_sx":
        raise ValueError(f"no pair enumeration for {cfg['routine']!r}")
    nb = int(cfg["panel_forward"])
    windowed = rec["launches"].get("symv_lower", 0) > 0
    shapes = []
    k = 0
    while n - k > nb + 2:
        shapes += [(n if windowed else n - k, c0) for c0 in range(0, nb, 2)]
        k += nb
    rest = n - k
    if rest:
        mp = rest + 2 + rest % 2
        shapes += [(mp, c0) for c0 in range(0, mp, 2)]
    return shapes


def bound_total_s(rec) -> float:
    return sum(bound_s(rec["dtype"], 2 * m * c0 + 8 * m + 4,
                       16 * m * c0 + 20 * m)
               for m, c0 in launch_shapes(rec))


def read(rec):
    times = [e - s for name, s, e in rec["ops"]
             if any(k in name for k in KERNELS)]
    if not times:
        return None
    shapes = launch_shapes(rec)
    launched = rec["launches"].get("pair_update")
    if launched != len(shapes):
        raise RuntimeError(
            f"pair_update_roofline: {len(shapes)} launches enumerated, the "
            f"program counted {launched}")
    return 100.0 * bound_total_s(rec) / sum(times)
