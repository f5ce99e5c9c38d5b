"""The enumeration of ``sub_matmul`` launches against the program's own
launches in a small CPU solve.  A CPU tensor takes the kernel's plain
version, which leaves ``kernels.LAUNCHES`` alone, so the test records
each call of ``kernels.sub_matmul`` (the one entry of every launch: the
reductions' trailing updates and the back-transform's blocks) with its
shape instead, and the card test holds the count to ``LAUNCHES``."""

from importlib import util

import pytest
import torch

from perfbench import gen, harness


def enumerate_shapes(root, rec):
    path = root / "perfbench" / "metrics" / "sub_matmul_roofline.py"
    spec = util.spec_from_file_location("sub_matmul_roofline", path)
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.launch_shapes(rec)


@pytest.mark.parametrize("mode", ["A", "N"])
@pytest.mark.parametrize("n,nb,nbb", [(200, 64, 128), (101, 16, 32),
                                      (70, 9, 20)])
def test_enumeration_matches_the_program(root, monkeypatch, small_spec,
                                         mode, n, nb, nbb):
    from eigenexa_tpu_torch.ops import kernels

    spec = small_spec("eigen_s-f64-n8192.A-random", n, mode=mode)
    spec["config"].update(panel_forward=nb, panel_backward=nbb)
    seen = []
    plain = kernels.sub_matmul

    def record(b, p, q, out=None):
        seen.append((b.shape[0], b.shape[1], p.shape[1]))
        return plain(b, p, q, out=out)

    monkeypatch.setattr(kernels, "sub_matmul", record)
    solve, _ = harness.solver(spec, torch.device("cpu"))
    a = gen.make_matrix(spec["traffic"]["matrix"], n, "float64", 5, "cpu")
    solve(a, False)
    rec = {"config": spec["config"], "traffic": spec["traffic"], "n": n}
    assert seen == enumerate_shapes(root, rec)
