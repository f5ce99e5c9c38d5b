"""Port ``eigen_gev`` (eigenexa_tpu_torch/solvers/gev.py), its checks and
its input generators against the JAX package on the CPU, at n = 96, f32
and f64.

B is the JAX package's ``designed(linspace(1, 2, n))``: the port is handed
the permutation that JAX's ``PRNGKey(0)`` draws.  A is Frank's matrix.
Tolerances relative to max|w|: 1e-12 in f64 and 1e-4 in f32 (two eigen_s
solves and three products, rounded in another order on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_, t  # noqa: E402

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu.solvers import gev as jgev  # noqa: E402
from eigenexa_tpu.testing import checks as jchecks  # noqa: E402
from eigenexa_tpu.testing import matgen as jmatgen  # noqa: E402
from eigenexa_tpu_torch.solvers.gev import gev_flop_model  # noqa: E402
from eigenexa_tpu_torch.testing import (b_orthogonality_check,  # noqa: E402
                                        designed, gev_residual_check,
                                        helmert_matrix)

N = 96
W_TOL = {np.float64: 1e-12, np.float32: 1e-4}


def _perm(n: int) -> np.ndarray:
    """The permutation that the JAX package's ``designed`` draws with its
    default key."""
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n))


@pytest.fixture(scope="module")
def problem():
    """(A, B) in f64 as numpy: Frank and the JAX package's designed B."""
    b = n_(jmatgen.designed(jnp.asarray(np.linspace(1.0, 2.0, N))))
    return n_(jmatgen.frank(N, jnp.float64)), b


@pytest.mark.parametrize("mode", ["A", "N"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eigen_gev_matches_jax(problem, dtype, mode):
    a, b = (x.astype(dtype) for x in problem)
    jw, jz, _ = jgev.eigen_gev(jnp.asarray(a), jnp.asarray(b), mode=mode)
    w, z, info = ext.eigen_gev(t(a), t(b), mode=mode)
    jw = n_(jw)
    assert w.dtype == torch.float64 and info.mode == mode and info.n == N
    assert np.abs(n_(w) - jw).max() < W_TOL[dtype] * np.abs(jw).max()
    if mode == "N":
        assert z is None and jz is None
        return
    assert z.shape == (N, N) and z.dtype == t(a).dtype
    res = gev_residual_check(t(a), t(b), z, w)
    orth = b_orthogonality_check(z, t(b))
    assert res.value < 768 and orth.value < 8, (res, orth)


def test_indefinite_b_poisons_the_result(problem):
    a, b = problem
    b = b.copy()
    b[0, 0] = -50.0
    w, z, _ = ext.eigen_gev(t(a), t(b))
    assert bool(torch.isnan(w).all() and torch.isnan(z).all())
    w, z, _ = ext.eigen_gev(t(a), t(b), mode="N")
    assert bool(torch.isnan(w).all()) and z is None


@pytest.mark.parametrize("mode", ["X", "T", "S", "C", "R"])
def test_other_modes_raise(problem, mode):
    a, b = problem
    with pytest.raises(ValueError, match="modes 'A' and 'N'"):
        ext.eigen_gev(t(a), t(b), mode=mode)


@pytest.mark.parametrize("n,nvec,mode", [(96, 96, "A"), (8192, 100, "A"),
                                         (500, 7, "N")])
def test_gev_flop_model_matches_jax(n, nvec, mode):
    assert gev_flop_model(n, nvec, mode) == jgev.gev_flop_model(n, nvec, mode)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gev_checks_match_jax(problem, dtype):
    """The two checks on the same (A, B, Z, w): the port's values equal the
    JAX package's to 1e-2 relative.  Each value measures rounding of the
    order of n·ε, which the check's own products, summed in another order,
    move by a small fraction of itself (1e-4 to 1e-3 seen at this size)."""
    a, b = (x.astype(dtype) for x in problem)
    w, z, _ = ext.eigen_gev(t(a), t(b))
    zj, wj = jnp.asarray(n_(z)), jnp.asarray(n_(w))
    pairs = ((gev_residual_check(t(a), t(b), z, w, nvec=50),
              jchecks.gev_residual_check(jnp.asarray(a), jnp.asarray(b), zj,
                                         wj, nvec=50)),
             (b_orthogonality_check(z, t(b)),
              jchecks.b_orthogonality_check(zj, jnp.asarray(b))))
    for mine, ref in pairs:
        assert mine.name == ref.name and mine.passed == ref.passed
        np.testing.assert_allclose(mine.value, ref.value, rtol=1e-2)


@pytest.mark.parametrize("n", [1, 2, 7, 96])
def test_helmert_and_designed_match_jax(n):
    """helmert_matrix bitwise; designed with JAX's permutation within
    n·1e-15 of its largest entry (one product of n terms, summed in another
    order), and its spectrum exact."""
    np.testing.assert_array_equal(n_(helmert_matrix(n)),
                                  n_(jmatgen.helmert_matrix(n)))
    w = np.linspace(1.0, 2.0, n)
    mine = n_(designed(w, perm=_perm(n)))
    ref = n_(jmatgen.designed(jnp.asarray(w)))
    assert np.abs(mine - ref).max() <= 1e-15 * np.abs(ref).max() * n
    np.testing.assert_allclose(np.linalg.eigvalsh(mine), w, atol=1e-13)
    assert designed(w, dtype=torch.float32, seed=3).dtype == torch.float32


def test_profile_fills_the_stage_split(problem):
    """profile=True times eigen_s(B), the spectral reduction, eigen_s(A′)
    and, in mode A, F·Z′; the profiled solve gives the unprofiled one's
    bits."""
    a, b = (t(x) for x in problem)
    w, z, info = ext.eigen_gev(a, b, profile=True)
    assert list(info.stages) == ["SOLVE-B", "REDUCE", "SOLVE-A'", "BACK"]
    assert all(row["seconds"] > 0 for row in info.stages.values())
    w0, z0, _ = ext.eigen_gev(a, b)
    assert torch.equal(w, w0) and torch.equal(z, z0)
    _, _, info_n = ext.eigen_gev(a, b, mode="N", profile=True)
    assert list(info_n.stages) == ["SOLVE-B", "REDUCE", "SOLVE-A'"]
