"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit) and the least time an operation could take.

The benchmark's configurations are float64, whose best exact rate is the
FP64 tensor cores' (DMMA), whether or not a kernel reaches for it.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12}
ITEMSIZE = {"float64": 8}


def bound_s(dtype: str, elements: float, flops: float) -> float:
    """Seconds the card needs at least: each input element read once and
    each output element written once at the memory rate, or the
    operations at the peak rate of their type, whichever is larger."""
    return max(elements * ITEMSIZE[dtype] / PEAK_BYTES_PER_S,
               flops / PEAK_FLOPS[dtype])
