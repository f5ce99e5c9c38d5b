"""BENCHMARK.json against the shape the benchmark file must have, every cell resolving to
its files, and a cell added by new files and entries alone."""

import json
import re
import shutil
import time

import pytest
import torch

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture
def bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_keys_names_and_bounds(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", ["eigen_s-f64-n8192.A-random",
                                  "eigen_s-f64-n8192.A-multiplicity"])
def test_every_cell_resolves_to_its_files(root, bench, cell):
    spec = harness.load_cell(cell, root)
    assert spec["config"]["n"] == 8192 and spec["config"]["dtype"] == "float64"
    assert spec["traffic"]["mode"] in ("A", "N")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(spec["metrics_dir"], m["name"]))
    # a limit for every number the cell compares
    needed = {"w_gap"} | ({"residual", "residual_sampled", "orthogonality"}
                          if spec["traffic"]["mode"] == "A" else set())
    assert set(spec["limits"]) == needed
    assert not (set(spec["config"]["reduced"]) - set(
        next(c for c in bench["configs"]
             if c["name"] == spec["cell"]["config"])["reduced"]))


def test_a_cell_added_by_files_and_entries_alone(root, tmp_path):
    """A new mix, its limits and a new metric, as files beside the
    benchmark's and entries appended to BENCHMARK.json: the harness runs
    the new cell and edits nothing it already had."""
    shutil.copytree(root / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    cell = "eigen_s-f64-n8192.N-multiplicity"
    (tmp_path / "perfbench" / "traffic" / "N-multiplicity.json").write_text(
        json.dumps({"mode": "N", "matrix": {"kind": "designed",
                                            "spectrum": "multiplicity"}}))
    (tmp_path / "perfbench" / "limits" / f"{cell}.json").write_text(
        json.dumps({"w_gap": {"limit": 1e4}}))
    (tmp_path / "perfbench" / "metrics" / "solves_done.py").write_text(
        "def read(rec):\n    return rec['solves']\n")
    bench["workloads"].append({"name": cell, "config": "eigen_s-f64-n8192",
                               "traffic": "N-multiplicity", "chips": 1,
                               "why": "a dummy mix"})
    bench["per_layer"].append({"name": "solves_done", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "solve_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_cell(cell, tmp_path)
    spec["config"]["n"] = 64
    out = harness.run_cell(spec, 7, 0.05, True, torch.device("cpu"),
                           time.perf_counter())
    assert out["correct"] and out["metrics"]["solves_done"]["value"] >= 1
    # the cell reports what its entries name: here no stage of the
    # program, and on the CPU nothing of the device
    assert set(out["metrics"]) == {"solves_done"}
    for p, data in before.items():
        assert p.read_bytes() == data
