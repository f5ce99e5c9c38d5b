"""The result line: its keys in order, the numbers compared last, and no
line at all where there is no card or no program."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [0, 1])
def test_keys_of_the_line(small_spec, trace):
    spec = small_spec("eigen_s-f64-n8192.A-random", 48)
    out = harness.run_cell(spec, 3, 0.02, bool(trace), torch.device("cpu"),
                           time.perf_counter())
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {"solve_s", "setup_s"} if not trace else {
        "trd_blk_s", "dc_tree_s", "trdbak_s"}
    assert set(out["metrics"]) == want
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_no_card_no_line(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "eigen_s-f64-n8192.A-random", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_no_line(root, tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/."""
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; sys.path.insert(0, '.');"
         "from perfbench import harness;"
         "spec = harness.load_cell('eigen_s-f64-n8192.A-random', "
         "harness.Path('.')); spec['config']['n'] = 32;"
         "harness.run_cell(spec, 1, 0.01, False, torch.device('cpu'), 0.0)"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "eigenexa_tpu_torch" in out.stderr


@pytest.mark.parametrize("mode", ["X", "S", "T", "C"])
def test_a_mode_the_reference_cannot_judge_is_refused(small_spec, mode):
    spec = small_spec("eigen_s-f64-n8192.A-random", 32)
    spec["traffic"]["mode"] = mode
    with pytest.raises(ValueError, match="no check for mode"):
        harness.run_cell(spec, 1, 0.01, False, torch.device("cpu"), 0.0)
