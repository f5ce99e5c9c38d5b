"""Port tridiagonal D&C (eigenexa_tpu_torch/solvers/dc_tree.py, dc.py)
against the JAX package at n=192.

w is compared to 1e-12·‖T‖ (f64 work in both).  S is never compared raw:
the leaf eigenvector signs from LAPACK (JAX) and from torch's eigh may
differ, so the eigenvectors are compared through cluster projectors and
must pass the reference's residual/orthogonality checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same_eigenspaces, n_, rng, t  # noqa: E402

from eigenexa_tpu.ops.householder import tridiagonalize  # noqa: E402
from eigenexa_tpu.solvers.dc_tree import solve_tridiag_dc as j_dc  # noqa: E402
from eigenexa_tpu.testing.matgen import frank  # noqa: E402
from eigenexa_tpu_torch.solvers import dc as tdc  # noqa: E402
from eigenexa_tpu_torch.solvers.dc_tree import (_pad_sizes,  # noqa: E402
                                                solve_tridiag_dc)
from eigenexa_tpu_torch.testing import (orthogonality_check,  # noqa: E402
                                        residual_check)

N = 192


def _random_tridiag(n, seed):
    r = rng(seed)
    return r.standard_normal(n), r.standard_normal(n - 1)


def _frank_tridiag(n):
    trd = tridiagonalize(frank(n, jnp.float64), nb=64)
    return n_(trd.d), n_(trd.e)


@pytest.mark.parametrize("kind,leaf", [("random", 32), ("frank", 32),
                                       ("random", 2), ("frank", 16)])
def test_dc_matches_jax(kind, leaf):
    d, e = _random_tridiag(N, 0) if kind == "random" else _frank_tridiag(N)
    jw, js = j_dc(jnp.asarray(d), jnp.asarray(e), leaf=leaf)
    w, s = solve_tridiag_dc(t(d), t(e), leaf=leaf)
    assert w.dtype == torch.float64 and s.shape == (N, N)
    scale = np.abs(n_(jw)).max()
    assert np.abs(n_(w) - n_(jw)).max() < 1e-12 * scale
    assert_same_eigenspaces(s, js, w, tol=1e-9, gap=1e-8 * scale)
    tt = tdc.assemble_tridiag(t(d), t(e))
    assert residual_check(tt, s, w).passed
    assert orthogonality_check(s).passed


def test_dc_f32_vectors_keep_f64_values():
    d, e = _random_tridiag(N, 1)
    w, s = solve_tridiag_dc(t(d, torch.float32), t(e, torch.float32))
    assert w.dtype == torch.float64 and s.dtype == torch.float32
    wd, _ = tdc.solve_tridiag_dense(t(d), t(e))
    tt = tdc.assemble_tridiag(t(d, torch.float32), t(e, torch.float32))
    assert residual_check(tt, s, w).passed
    assert orthogonality_check(s).passed
    assert np.abs(n_(w) - n_(wd)).max() < 1e-5 * np.abs(n_(wd)).max()


def test_dense_oracle_and_facade_agree():
    d, e = _random_tridiag(100, 2)
    wd, sd = tdc.solve_tridiag_dense(t(d), t(e))
    w, s = tdc.solve_tridiag(t(d), t(e))
    assert np.abs(n_(w) - n_(wd)).max() < 1e-12 * np.abs(n_(wd)).max()
    assert_same_eigenspaces(s, sd, w, tol=1e-9, gap=1e-8)


def test_dc_small_and_degenerate_sizes():
    w, s = solve_tridiag_dc(t(np.array([2.5])), t(np.zeros(0)))
    assert n_(w).tolist() == [2.5] and n_(s).tolist() == [[1.0]]
    d, e = np.array([1.0, 1.0, 1.0]), np.zeros(2)       # already diagonal
    w, s = solve_tridiag_dc(t(d), t(e))
    np.testing.assert_allclose(n_(w), d)
    np.testing.assert_allclose(np.abs(n_(s)) @ np.ones(3), np.ones(3))
    assert _pad_sizes(192, 32) == (256, 3)
    assert _pad_sizes(8192, 32) == (8192, 8)


def test_dc_nan_input_poisons():
    d, e = _random_tridiag(64, 3)
    d[5] = np.nan
    w, s = solve_tridiag_dc(t(d), t(e))
    assert torch.isnan(w).all() and torch.isnan(s).all()
