"""kernels_per_solve: device kernels launched by the profiled solve
(``torch.profiler``, CUDA activity; copies and sets not counted)."""

from perfbench.devtrace import is_kernel


def read(rec):
    if not rec["ops"]:
        return None
    return sum(1 for name, _, _ in rec["ops"] if is_kernel(name))
