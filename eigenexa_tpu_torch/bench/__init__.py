"""Benchmark application layer (counterpart of ``eigenexa_tpu/bench``;
reference: benchmark/main2.f)."""

from eigenexa_tpu_torch.bench.runner import (BenchCase, run_case,
                                          run_distributed, run_independent,
                                          run_input_file, run_mesh_case)

__all__ = ["run_case", "run_input_file", "BenchCase", "run_distributed",
           "run_mesh_case", "run_independent"]
