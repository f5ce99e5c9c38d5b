"""Device barrier and stage timer (counterpart of ``eigenexa_tpu/utils``)."""

from eigenexa_tpu_torch.utils.profiler import Profiler, profile_region

__all__ = ["Profiler", "profile_region"]
