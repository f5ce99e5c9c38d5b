"""The harness on the card, at orders a test run holds: every cell's run
with the trace, the launch count held to ``kernels.LAUNCHES``, and the
control.  Marked ``gpu``; skips without a card.

    python -m pytest perfbench/tests -q -m gpu
"""

import time

import pytest

from perfbench import harness, readings

pytestmark = pytest.mark.gpu

CELLS = ["eigen_s-f64-n8192.A-random", "eigen_s-f64-n8192.A-multiplicity"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cuda_device, small_spec, cell):
    spec = small_spec(cell, 1024)
    out = harness.run_cell(spec, 2**31 + 99, 1.0, True, cuda_device,
                           time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == 1
    assert out["device"]["busy_s"] > 0
    # sub_matmul_roofline raises where the enumeration misses LAUNCHES
    want = {m["name"] for m in spec["per_layer"]}
    assert set(out["metrics"]) == want
    assert 0 < out["metrics"]["sub_matmul_roofline"]["value"] <= 100
    assert 0 < out["metrics"]["device_idle"]["value"] < 100
    out = harness.run_cell(spec, 5, 1.0, False, cuda_device,
                           time.perf_counter())
    assert out["correct"]
    assert set(out["metrics"]) == {"solve_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda_device, small_spec, cell):
    spec = small_spec(cell, 1024)
    assert readings.reading(spec, 11, cuda_device)["correct"]
    assert not readings.reading(spec, 11, cuda_device, control=True)[
        "correct"]
