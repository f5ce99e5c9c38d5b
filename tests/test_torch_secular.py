"""Port batched rank-1 merges (eigenexa_tpu_torch/ops/secular.py) against
the JAX package's ``rank1_merge_core`` (jitted, merge by merge).

λ is compared to 1e-12·scale (f64 secular work in both, different
summation order).  The transforms C are compared through the projectors of
each eigenvalue cluster (tests/test_native.py compares projectors too):
column signs and the basis inside a deflated cluster are free.  Each port
result must also diagonalize its merge matrix to f64 roundoff.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same_eigenspaces, n_, rng, t  # noqa: E402

from eigenexa_tpu.ops import secular as js  # noqa: E402
from eigenexa_tpu_torch.ops import secular as ts  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
M = 32  # width of the synthetic merges: one JAX compile serves them all
_JAX_CORE = jax.jit(functools.partial(js.rank1_merge_core, n_iter=40,
                                      work_dtype=jnp.float64))


def _jax_batch(d, z, rho):
    """The JAX core merge by merge (the port takes the whole batch)."""
    out = [_JAX_CORE(jnp.asarray(d[b]), jnp.asarray(z[b]),
                     jnp.asarray(rho[b])) for b in range(d.shape[0])]
    return tuple(np.stack([n_(getattr(c, f)) for c in out])
                 for f in ("lam", "c", "perm"))


def _unsorted(c, perm):
    """Rows of c back in the caller's coordinate order."""
    cu = np.zeros_like(c)
    cu[perm, :] = c
    return cu


def _check_batch(d, z, rho, gap_rel=1e-8):
    core = ts.rank1_merge_core(t(d), t(z), t(rho))
    lam, c, perm = n_(core.lam), n_(core.c), n_(core.perm)
    jlam, jc, jperm = _jax_batch(d, z, rho)
    bsz, m = d.shape
    for b in range(bsz):
        scale = max(np.abs(d[b]).max(), rho[b] * np.abs(z[b]).max() ** 2)
        assert np.abs(lam[b] - jlam[b]).max() < 1e-12 * scale
        cu = _unsorted(c[b], perm[b])
        assert_same_eigenspaces(cu, _unsorted(jc[b], jperm[b]), lam[b],
                                tol=1e-10, gap=gap_rel * scale)
        a = np.diag(d[b]) + rho[b] * np.outer(z[b], z[b])
        resid = a @ cu - cu * lam[b][None, :]
        assert np.abs(resid).max() < 1e-12 * scale * m
        assert np.abs(cu.T @ cu - np.eye(m)).max() < 1e-13 * m


def test_merge_random_batch():
    r = rng(0)
    d = r.standard_normal((6, M))
    z = r.standard_normal((6, M))
    rho = np.abs(r.standard_normal(6)) + 0.1
    _check_batch(d, z, rho)


def test_merge_unsorted_coordinates():
    r = rng(1)
    d = r.permutation(np.linspace(-3, 3, M))[None, :]
    _check_batch(d, r.standard_normal((1, M)), np.array([0.7]))


def test_merge_clustered_runs():
    """Exact repeats and near-repeats: the run rotation deflates them."""
    r = rng(2)
    base = np.repeat(np.linspace(-1, 1, M // 4), 4)      # runs of 4
    d = np.stack([base, base + 1e-17 * r.standard_normal(M)])
    z = r.standard_normal((2, M))
    _check_batch(d, z, np.array([0.5, 2.0]))


def test_merge_deflating_z():
    """Tiny couplings deflate in place as exact unit columns."""
    r = rng(3)
    d = r.standard_normal((3, M))
    z = r.standard_normal((3, M))
    z[:, ::3] = 1e-20
    z[2, :] = 0.0                                         # all deflated
    _check_batch(d, z, np.array([1.0, 0.3, 1.0]))
    core = ts.rank1_merge_core(t(d[2:]), t(z[2:]), t(np.array([1.0])))
    np.testing.assert_array_equal(n_(core.lam)[0], np.sort(d[2]))


@pytest.mark.parametrize("fixture", ["onpole_own", "onpole_upper"])
def test_on_pole_merges(fixture):
    """The real merges extracted from an n=8192 tree (tests/data) whose
    roots converge onto a pole must come out as unit columns, not the 0/0
    secular formula (the JAX package's tests/test_dc_tree.py checks its
    own core the same way)."""
    dd = np.load(os.path.join(DATA, fixture + ".npz"))
    dm, z, rho = dd["dm"], dd["z"], float(dd["rho"])
    m = dm.shape[0]
    core = ts.rank1_merge_core(t(dm[None]), t(z[None]), t(np.array([rho])))
    lam = n_(core.lam)[0]
    cu = _unsorted(n_(core.c)[0], n_(core.perm)[0])
    mcu = dm[:, None] * cu + rho * np.outer(z, z @ cu)
    res = np.linalg.norm(mcu - cu * lam[None, :], axis=0)
    assert res.max() < 1e-11 * max(np.abs(dm).max(), 1.0), res.max()
    assert np.abs(cu.T @ cu - np.eye(m)).max() < 1e-12
    wt = np.linalg.eigvalsh(np.diag(dm) + rho * np.outer(z, z))
    np.testing.assert_allclose(np.sort(lam), wt, atol=1e-12)
    jlam, _, _ = _jax_batch(dm[None], z[None], np.array([rho]))
    np.testing.assert_allclose(lam, jlam[0], atol=1e-12)


def test_run_rotation_is_orthogonal_and_concentrates_weight():
    d = np.repeat(np.arange(5.0), 3)[None, :]
    z = rng(4).standard_normal((1, 15))
    zr, u_hat, leaders, tiles = ts._rotate_runs(t(d), t(z),
                                                t(np.array([1e-12])), 15)
    eye = torch.eye(15, dtype=torch.float64)[None]
    g = ts.apply_run_rotation(eye, u_hat, leaders, tiles)[0]
    np.testing.assert_allclose(n_(g @ g.T), np.eye(15), atol=1e-14)
    np.testing.assert_allclose(n_(g @ t(z[0])), n_(zr)[0], atol=1e-14)
    assert np.count_nonzero(n_(zr)[0]) == 5            # one per run
