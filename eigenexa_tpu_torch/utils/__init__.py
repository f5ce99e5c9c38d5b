"""Device barrier, stage timer and spans (counterpart of
``eigenexa_tpu/utils``)."""

from eigenexa_tpu_torch.utils.profiler import Profiler, count, span

__all__ = ["Profiler", "count", "span"]
