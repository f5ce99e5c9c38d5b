"""sub_matmul_roofline: the hand-written ``sub_matmul`` kernel's share of
its roofline over one profiled solve, %: the sum of each launch's bound
time over the sum of the kernel's device time.

The launches are enumerated from n, the mode and the panel widths of
``eigen_s``'s rolled reduction: the rank-2nb trailing update of each panel,
in place on the live block ((n−k−nb)² × 2nb), and, where vectors are
back-transformed, each WY block of the back-transform (rows n−k, n
columns, min(nbb, n−1−k) reflectors).  The enumeration has to match the
program's own count of launches (``kernels.LAUNCHES``) over the profiled
solve, or the run fails: the bound would be of other work than timed.

A launch's bound (``peaks.bound_s``): B read and OUT written once, P and
Q read once (2·m·n + (m+n)·k elements), against 2·m·n·k operations."""

from perfbench.peaks import bound_s

KERNEL = "sub_matmul_kernel"     # every __global__ of csrc/sub_matmul.cu


def launch_shapes(rec) -> list:
    """(m, n, k) of every ``sub_matmul`` launch of one solve, in order."""
    cfg, n = rec["config"], rec["n"]
    nb, nbb = int(cfg["panel_forward"]), int(cfg["panel_backward"])
    if cfg["routine"] != "eigen_s":
        raise ValueError(f"no sub_matmul enumeration for {cfg['routine']!r}")
    shapes = []
    k = 0
    while n - k > nb:
        m = n - k - nb
        shapes.append((m, m, 2 * nb))
        k += nb
    if rec["traffic"]["mode"] == "A":
        for k in reversed(range(0, n - 1, nbb)):
            shapes.append((n - k, n, min(nbb, n - 1 - k)))
    return shapes


def bound_total_s(rec) -> float:
    return sum(bound_s(rec["dtype"], 2 * m * c + (m + c) * k, 2 * m * c * k)
               for m, c, k in launch_shapes(rec))


def read(rec):
    times = [e - s for name, s, e in rec["ops"] if KERNEL in name]
    if not times:
        return None
    shapes = launch_shapes(rec)
    launched = rec["launches"].get("sub_matmul")
    if launched != len(shapes):
        raise RuntimeError(
            f"sub_matmul_roofline: {len(shapes)} launches enumerated, the "
            f"program counted {launched}")
    return 100.0 * bound_total_s(rec) / sum(times)
