"""pair_reflectors_roofline: the hand-written ``pair_reflectors`` kernel's
share of its roofline over one profiled solve, %: the sum of each launch's
bound time over the sum of the kernel's device time.

The launches are enumerated from n and the panel width of ``eigen_sx``'s
band-2 reduction (``ops/band.py``): a panel of nb columns is nb/2 pairs,
panels run while more than nb + 2 rows are live, and the remainder's m
rows, padded to an even m + 2 or m + 3, give a launch to every pair but
the last, whose pivots lie past them.  A pair of the rolled reduction
reads the live block's rows, one of the windowed reduction all n (it ran
where the profiled solve launched ``symv_lower``).  The enumeration has to
match the program's own count of launches (``kernels.LAUNCHES``) over the
profiled solve, or the run fails: the bound would be of other work than
timed.

A launch's bound (``peaks.bound_s``) with m rows and the first pivot p:
the two columns read from row p and V written, 2·(m − p) + 2·m elements,
with τ and T; against its real operations, about 30 a row from p
(CholeskyQR2's three dots and two updates, each reflector's max, scaled
sum and quotients, the fix-up g·v₀ and v₀·v₁).  The kernel is one block,
bound by its latency: the share is small by design, and it moves where
a pair's passes over its rows get fewer."""

from perfbench.peaks import bound_s

KERNEL = "pair_reflectors_kernel"    # csrc/householder.cu
OPS_PER_ROW = 30


def launch_shapes(rec) -> list:
    """(m, p) of every ``pair_reflectors`` launch of one solve, in order."""
    cfg, n = rec["config"], rec["n"]
    if cfg["routine"] != "eigen_sx":
        raise ValueError(f"no pair enumeration for {cfg['routine']!r}")
    nb = int(cfg["panel_forward"])
    windowed = rec["launches"].get("symv_lower", 0) > 0
    shapes = []
    k = 0
    while n - k > nb + 2:
        shapes += [(n if windowed else n - k, (k if windowed else 0) + c0 + 2)
                   for c0 in range(0, nb, 2)]
        k += nb
    rest = n - k
    if rest:
        mp = rest + 2 + rest % 2
        shapes += [(mp, c0 + 2) for c0 in range(0, mp - 2, 2)]
    return shapes


def bound_total_s(rec) -> float:
    return sum(bound_s(rec["dtype"], 2 * (m - p) + 2 * m + 6,
                       OPS_PER_ROW * (m - p))
               for m, p in launch_shapes(rec))


def read(rec):
    times = [e - s for name, s, e in rec["ops"] if KERNEL in name]
    if not times:
        return None
    shapes = launch_shapes(rec)
    launched = rec["launches"].get("pair_reflectors")
    if launched != len(shapes):
        raise RuntimeError(
            f"pair_reflectors_roofline: {len(shapes)} launches enumerated, "
            f"the program counted {launched}")
    return 100.0 * bound_total_s(rec) / sum(times)
