"""The check must fail what it is there to catch, at a size a test run
holds: the control (the program's own float32 path, the precision below
the configurations' float64) and the faults a solve can have, each
planted under the harness's run."""

import time

import pytest
import torch

from perfbench import harness, readings

# (cell, mode): every cell, and mode N of A-random's matrices
CELLS = [("eigen_s-f64-n8192.A-random", None),
         ("eigen_s-f64-n8192.A-random", "N"),
         ("eigen_s-f64-n8192.A-multiplicity", None)]
N = 96


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 7, 90210])
def test_program_passes_and_control_fails(small_spec, cell, seed):
    spec = small_spec(cell[0], N, mode=cell[1])
    cpu = torch.device("cpu")
    program = readings.reading(spec, seed, cpu)
    control = readings.reading(spec, seed, cpu, control=True)
    assert program["correct"] and not control["correct"]
    # the control fails by orders of magnitude, not by a hair
    assert control["values"]["w_gap"] > 1e3 * program["values"]["w_gap"]


def _run(spec):
    return harness.run_cell(spec, 4, 0.01, False, torch.device("cpu"),
                            time.perf_counter())


def _faults(mode):
    """(name, module attribute to wrap, wrapper) of every fault a cell of
    ``mode`` can have; the exchange between chips has no place on one."""
    import eigenexa_tpu_torch.solvers.solver as solver

    def unchanged(fn):
        # a step that returns its state unchanged: the back-transform (or
        # the bisection) hands back what it was given
        if mode == "N":
            return lambda d, *offd: d.clone()
        return lambda z, *args, **kw: z

    def half(fn):
        # half of the batch left out, the mean taken over the rest
        def wrapped(*args, **kw):
            w, z = fn(*args, **kw)
            h = w.shape[0] // 2
            w = w.clone()
            w[h:] = w[:h].mean()
            if z is not None:
                z = z.clone()
                z[:, h:] = z[:, :h].mean(dim=1, keepdim=True)
            return w, z
        return wrapped

    def altered(fn):
        # one answer altered where it is produced
        def wrapped(*args, **kw):
            w, z = fn(*args, **kw)
            w = w.clone()
            w[3] += 1e-9 * w.abs().max()
            if z is not None:
                z = z.clone()
                z[5, 7] += 1e-6
            return w, z
        return wrapped

    step = ("eigenexa_tpu_torch.ops.sturm", "eigvals_bisect") if mode == "N" \
        else (solver, "back_transform")
    return [("unchanged", step, unchanged), ("half", (solver, "_solve"), half),
            ("altered", (solver, "_solve"), altered)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_planted_fault_is_not_correct(small_spec, monkeypatch, cell, fault):
    import importlib

    spec = small_spec(cell[0], N, mode=cell[1])
    assert _run(spec)["correct"]
    for name, (owner, attr), wrap in _faults(spec["traffic"]["mode"]):
        if name != fault:
            continue
        if isinstance(owner, str):
            owner = importlib.import_module(owner)
        monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    out = _run(spec)
    assert not out["correct"]
    assert out["failed"] >= 1
