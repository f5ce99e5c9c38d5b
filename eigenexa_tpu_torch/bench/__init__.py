"""Benchmark application layer (counterpart of ``eigenexa_tpu/bench``;
reference: benchmark/main2.f)."""

from eigenexa_tpu_torch.bench.runner import (BenchCase, run_case,
                                          run_input_file)

__all__ = ["run_case", "run_input_file", "BenchCase"]
