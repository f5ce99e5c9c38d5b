"""Port ``mat_set`` and ``w_set`` (eigenexa_tpu_torch/testing/matgen.py)
against the JAX package on the CPU, every matrix type, at n ≤ 128.

Tolerances: the matrices of types 0, 1 and 3 and the spectra of types 4,
6, 7 and 10 within 1 ulp of the JAX package's (the same operations in the
same dtype).  Type 5's sin³: its θ is the same bits, and ``sin`` within 1
ulp in the two libraries, 3 ulps once cubed.  The Frank spectrum in f64 is
the other exception: the port takes 1/(4 sin²(θ/2)), the
JAX package 1/(2(1 − cos θ)), whose cancellation costs up to ε·w² (ROADMAP
§ C).  ``designed`` with the JAX package's permutation handed across within
1e-13 of max|w|, as its product rounds in another order.  Types 8 and 9
draw from numpy seeds, where the JAX package draws from jax keys, so they
are held to their own spectra: ``numpy.linalg.eigvalsh`` of A within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_  # noqa: E402

from eigenexa_tpu.testing import matgen as jmatgen  # noqa: E402
from eigenexa_tpu_torch.testing import (MATRIX_TYPES, designed,  # noqa: E402
                                        mat_set, w_set)

N = 96
DTYPES = [(torch.float32, jnp.float32, np.float32),
          (torch.float64, jnp.float64, np.float64)]


def _jax_perm(n: int) -> np.ndarray:
    """The permutation the JAX package's ``designed`` draws."""
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("mtype", [0, 1, 3])
def test_analytic_matrices_match_jax(mtype, dtypes):
    tdt, jdt, ndt = dtypes
    a, w_true = mat_set(N, mtype, dtype=tdt)
    ja, jw = jmatgen.mat_set(N, mtype, dtype=jdt)
    assert a.dtype == tdt and a.shape == (N, N)
    np.testing.assert_array_max_ulp(n_(a), n_(ja).astype(ndt), maxulp=1)
    assert (w_true is None) == (jw is None) == (mtype == 1)
    if w_true is not None:
        assert w_true.dtype == tdt
        np.testing.assert_allclose(np.linalg.eigvalsh(n_(a).astype(
            np.float64)), n_(w_true), rtol=1e-5 if ndt == np.float32
            else 1e-12, atol=0)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("mtype", [4, 5, 6, 7, 10])
def test_designed_spectra_match_jax(mtype, dtypes):
    tdt, jdt, ndt = dtypes
    w_file = np.random.default_rng(10).uniform(-2.0, 5.0, N)
    w = n_(w_set(N, mtype, tdt, w_file=w_file))
    jw = n_(jmatgen.w_set(N, mtype, jdt, w_file=w_file)).astype(ndt)
    assert w.dtype == ndt and w.shape == (N,)
    if mtype == 7 and ndt == np.float64:
        # the JAX package's 1 − cos θ cancels: |Δw| ≤ ε·w² a value
        bound = np.spacing(jw) + 2 * np.finfo(ndt).eps * jw ** 2
        assert np.all(np.abs(w - jw) <= bound)
        assert np.abs(w - jw).max() > 0   # the two forms do differ here
    elif mtype == 5:
        # θ is the same bits; sin within 1 ulp, cubed: (1 + δ)³ ≈ 1 + 3δ
        np.testing.assert_array_max_ulp(w, jw, maxulp=3)
    else:
        np.testing.assert_array_max_ulp(w, jw, maxulp=1)


@pytest.mark.parametrize("mtype", [4, 5, 6, 7, 10])
def test_designed_matrices_match_jax(mtype):
    """A of types 4-10 as the JAX package builds it, its permutation
    handed across; w_true the sorted spectrum."""
    w_file = np.random.default_rng(10).uniform(-2.0, 5.0, N)
    ja, jw = jmatgen.mat_set(N, mtype, w_file=w_file)
    w = w_set(N, mtype, w_file=w_file)
    a = n_(designed(w, perm=_jax_perm(N)))
    scale = max(np.abs(n_(w)).max(), 1.0)
    assert np.abs(a - n_(ja)).max() < 1e-13 * scale
    _, w_true = mat_set(N, mtype, w_file=w_file)
    np.testing.assert_array_equal(n_(w_true), np.sort(n_(w)))
    np.testing.assert_allclose(n_(w_true), n_(jw), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("mtype", [8, 9])
def test_random_spectra_are_the_matrix_spectra(mtype):
    a, w_true = mat_set(N, mtype)
    w = n_(w_true)
    assert np.all(np.diff(w) >= 0)
    if mtype == 8:
        assert w.min() >= 0.0 and w.max() < 1.0
    np.testing.assert_allclose(np.linalg.eigvalsh(n_(a)), w, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(n_(a), n_(a).T, rtol=0, atol=1e-14)
    again, _ = mat_set(N, mtype, dtype=torch.float32)
    assert again.dtype == torch.float32


@pytest.mark.parametrize("mtype", [-1, -2])
def test_matrix_market_matches_jax(mtype, tmp_path, monkeypatch):
    """A.mtx (type −1) or B.mtx (type −2) in the working directory, not
    symmetric, read and symmetrized bitwise as the JAX package does."""
    import scipy.io

    u = np.random.default_rng(5).standard_normal((40, 40))
    scipy.io.mmwrite(str(tmp_path / ("A.mtx" if mtype == -1 else "B.mtx")),
                     u)
    monkeypatch.chdir(tmp_path)
    a, w_true = mat_set(0, mtype)
    ja, jw = jmatgen.mat_set(0, mtype)
    assert w_true is None and jw is None
    np.testing.assert_array_equal(n_(a), n_(ja))
    np.testing.assert_array_equal(n_(a), u + u.T)


def test_w_dat_file(tmp_path):
    w = np.linspace(-2, 5, 30)
    path = tmp_path / "W.dat"
    np.savetxt(path, w)
    a, w_true = mat_set(30, 10, w_file=str(path))
    np.testing.assert_allclose(np.linalg.eigvalsh(n_(a)), np.sort(w),
                               atol=1e-12)
    np.testing.assert_array_equal(n_(w_true), np.sort(w))


def test_every_type_named_and_unknown_types_raise():
    assert MATRIX_TYPES == jmatgen.MATRIX_TYPES
    for mtype in MATRIX_TYPES:
        a, _ = mat_set(16, mtype, dtype=torch.float32,
                       w_file=np.arange(16.0))
        assert a.dtype == torch.float32 and a.shape == (16, 16)
        assert torch.equal(a, a.T) or mtype >= 4
    for bad in (11, -3):
        with pytest.raises(ValueError, match="unknown matrix type"):
            mat_set(16, bad)
    with pytest.raises(ValueError, match="w_file"):
        mat_set(16, 10)
    with pytest.raises(ValueError, match="no designed spectrum"):
        w_set(16, 2)
