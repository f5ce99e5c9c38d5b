"""Port band-2 path (eigenexa_tpu_torch/ops/band.py, solvers/dc_band.py,
utils/stageio.py) against the JAX package's ops/band.py,
solvers/dc_band.py and utils/stageio.py, on the CPU.

Tolerances: the bands of an f64 reduction within 1e-10·‖A‖ of JAX's (two
correct reductions round otherwise in the reflectors' norms and products;
1e-10 leaves room for the growth over n ≤ 128 columns); spectra against
numpy's eigvalsh within 1e-10·‖A‖ in f64 and 50·n·ε·‖A‖ in f32 (the
backward error of a Householder reduction); the D&C's w within
1e-11·‖T‖ of JAX's (both f64, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_, rng, sym, t  # noqa: E402

from eigenexa_tpu.ops import band as jb  # noqa: E402
from eigenexa_tpu.solvers import dc_band as jd  # noqa: E402
from eigenexa_tpu.utils import stageio as jio  # noqa: E402
from eigenexa_tpu_torch.ops import band as tb  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402
from eigenexa_tpu_torch.solvers import dc_band as td  # noqa: E402
from eigenexa_tpu_torch.solvers.trbak import back_transform  # noqa: E402
from eigenexa_tpu_torch.testing import (orthogonality_check,  # noqa: E402
                                        residual_check)
from eigenexa_tpu_torch.utils import stageio as tio  # noqa: E402


def _norm2(a) -> float:
    return float(np.abs(np.linalg.eigvalsh(np.asarray(a, np.float64))).max())


@pytest.mark.parametrize("c0", [0, 5, 16, 17, 18])
def test_pair_reflectors_match_jax(c0):
    """Columns of an m = 20 panel down to the edge, where the second
    reflector's pivot (c0 + 3) and then the first's leave the matrix."""
    g = rng(40 + c0)
    x0, x1 = g.standard_normal(20), g.standard_normal(20)
    x1[c0 + 2:] += 0.999 * x0[c0 + 2:]          # nearly parallel columns
    jv, jt0, jt1, jt = jb.pair_reflectors(jnp.asarray(x0), jnp.asarray(x1),
                                          c0, jnp.arange(20))
    v, tau, tt = tk.pair_reflectors(t(np.stack([x0, x1], axis=1)), c0)
    for got, want in ((v, jv), (tau[0], jt0), (tau[1], jt1), (tt, jt)):
        np.testing.assert_allclose(n_(got), n_(want), rtol=1e-11,
                                   atol=1e-13)


@pytest.mark.parametrize("impl", ["rolled", "windowed"])
@pytest.mark.parametrize("n", [7, 128])
def test_band2_reduce_bands_match_jax_f64(n, impl):
    a = sym(n, 41)
    got = tb.band2_reduce(t(a), nb=16, impl=impl)
    want = jb.band2_reduce(jnp.asarray(a), nb=16, impl=impl)
    tol = 1e-10 * _norm2(a)
    assert got.e1.shape == (n - 1,) and got.e2.shape == (n - 2,)
    for name in ("d", "e1", "e2"):
        np.testing.assert_allclose(n_(getattr(got, name)),
                                   n_(getattr(want, name)), rtol=0, atol=tol)
    np.testing.assert_allclose(n_(got.tau), n_(want.tau), rtol=0, atol=1e-10)


def _check_reduction(a, red, dtype):
    """The pentadiagonal keeps A's spectrum, and the back-transform of the
    identity gives an orthogonal Q with QᵀAQ pentadiagonal."""
    n = a.shape[0]
    eps = float(np.finfo(dtype).eps)
    norm = _norm2(a)
    tol = 1e-10 * norm if dtype == np.float64 else 50 * n * eps * norm
    p = n_(tb.assemble_band2(red.d, red.e1, red.e2)).astype(np.float64)
    np.testing.assert_allclose(np.linalg.eigvalsh(p), np.linalg.eigvalsh(a),
                               rtol=0, atol=tol)
    q = back_transform(torch.eye(n, dtype=red.v.dtype), red.v, red.tau)
    assert orthogonality_check(q).passed
    qaq = n_(q.T @ t(a, red.v.dtype) @ q).astype(np.float64)
    assert np.abs(np.triu(qaq, 3)).max() < tol
    np.testing.assert_allclose(qaq, p, rtol=0, atol=tol)


@pytest.mark.parametrize("impl", ["rolled", "windowed"])
def test_band2_reduce_f32_keeps_the_spectrum(impl):
    a = sym(128, 42).astype(np.float32)
    red = tb.band2_reduce(t(a), nb=16, impl=impl)
    assert red.d.dtype == red.v.dtype == torch.float32
    _check_reduction(a.astype(np.float64), red, np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_windowed_band2_reaches_a_later_window(dtype, monkeypatch):
    """n = 600 with panels of 64: the last panel runs in window t0 = 1
    (rows and columns from 512).  Every pair's matvec is one symv_lower
    call with nc = 2 into its window group's workspace."""
    a = sym(600, 43).astype(dtype)
    calls = []
    real = tk.symv_lower

    def spy(b, x, t0=0, **kw):
        calls.append((t0, tuple(x.shape), kw["out"].data_ptr()))
        return real(b, x, t0=t0, **kw)

    monkeypatch.setattr(tb, "symv_lower", spy)
    red = tb.band2_reduce(t(a), nb=64, impl="windowed")
    panels = (600 - 64 - 2 + 63) // 64          # while n − k > nb + 2
    assert len(calls) == panels * 32
    assert {c[1] for c in calls} == {(600, 2)}
    assert [c[0] for c in calls[::32]] == [0] * (panels - 1) + [1]
    assert len({c[2] for c in calls if c[0] == 0}) == 1   # one workspace
    _check_reduction(a.astype(np.float64), red, dtype)


def test_band2_reduce_keeps_its_input_unless_donated():
    a = t(sym(40, 44))
    keep = a.clone()
    tb.band2_reduce(a, nb=8)
    assert torch.equal(a, keep)
    red = tb.band2_reduce(a, nb=8, impl="windowed", donate=True)
    assert red.v.data_ptr() == a.data_ptr()
    with pytest.raises(ValueError, match="impl"):
        tb.band2_reduce(keep, impl="diagonal")


@pytest.mark.parametrize("n", [2, 3, 100])
def test_solve_band2_dc_matches_jax(n):
    g = rng(45 + n)
    d, e1, e2 = (g.standard_normal(n), g.standard_normal(n - 1),
                 g.standard_normal(n - 2))
    p = n_(tb.assemble_band2(t(d), t(e1), t(e2)))
    w, s = td.solve_band2_dc(t(d), t(e1), t(e2), leaf=16)
    jw, _ = jd.solve_band2_dc(jnp.asarray(d), jnp.asarray(e1),
                              jnp.asarray(e2), leaf=16, impl="jax")
    assert w.dtype == torch.float64 and s.shape == (n, n)
    np.testing.assert_allclose(n_(w), n_(jw), rtol=0, atol=1e-11 * _norm2(p))
    assert residual_check(t(p), s, w).passed
    assert orthogonality_check(s).passed


def test_solve_band2_dc_f32_vectors_and_nan_poisoning():
    g = rng(46)
    d, e1, e2 = (t(g.standard_normal(70)), t(g.standard_normal(69)),
                 t(g.standard_normal(68)))
    w, s = td.solve_band2_dc(d, e1, e2, vec_dtype=torch.float32)
    assert w.dtype == torch.float64 and s.dtype == torch.float32
    assert residual_check(tb.assemble_band2(d, e1, e2).float(), s,
                          w).passed
    d[5] = float("nan")
    w, s = td.solve_band2_dc(d, e1, e2)
    assert torch.isnan(w).all() and torch.isnan(s).all()
    w1, s1 = td.solve_band2_dc(d[:1], e1[:0], e2[:0])
    assert w1.shape == (1,) and s1.tolist() == [[1.0]]


def test_stageio_round_trip_and_the_jax_files(tmp_path):
    """save → load gives the same bits, F.data only for a pentadiagonal;
    files the JAX package writes read back the same in the port."""
    g = rng(47)
    d, e, e2 = g.standard_normal(30), g.standard_normal(29), \
        g.standard_normal(28)
    tio.save_stage_data(tmp_path / "p", t(d), t(e), t(e2))
    tio.save_stage_data(tmp_path / "t", d, e)
    jio.save_stage_data(str(tmp_path / "j"), jnp.asarray(d), jnp.asarray(e),
                        jnp.asarray(e2))
    for name in ("p", "j"):
        ld, le, le2 = tio.load_stage_data(tmp_path / name)
        assert ld.dtype == torch.float64
        for got, want in ((ld, d), (le, e), (le2, e2)):
            np.testing.assert_array_equal(n_(got), want)
    ld, le, le2 = tio.load_stage_data(tmp_path / "t",
                                      dtype=torch.float32)
    assert le2 is None and ld.dtype == torch.float32
    jd_, je_, _ = jio.load_stage_data(str(tmp_path / "p"))
    np.testing.assert_array_equal(n_(jd_), d)
    np.testing.assert_array_equal(n_(je_), e)
