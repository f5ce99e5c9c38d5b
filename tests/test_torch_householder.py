"""Port Householder reduction (eigenexa_tpu_torch/ops/householder.py) and
back-transform (solvers/trbak.py) against the JAX package at n=192, f64.

Both packages share the dlarfg reflector convention, so d, e, v and tau
are compared directly.  Tolerance rtol 1e-12·n relative to each array's
largest entry: the two packages round in another order (the JAX path pads
its trailing blocks into buckets and fuses differently), and the
reduction's backward error grows like n·ε.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_, rng, sym, t  # noqa: E402

from eigenexa_tpu.ops import householder as jh  # noqa: E402
from eigenexa_tpu.solvers import trbak as jtr  # noqa: E402
from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.solvers import trbak as ttr  # noqa: E402

N = 192
TOL = 1e-12 * N


def _close(a, b, tol=TOL):
    a, b = n_(a), n_(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


@pytest.mark.parametrize("p", [1, 5, 63, 64])
def test_householder_vector_matches_jax(p):
    x = rng(p).standard_normal(65)
    if p == 63:
        x[p + 1:] = 0.0                      # nothing to annihilate
    idx = np.arange(65)
    jv, jtau, jbeta = jh.householder_vector(jnp.asarray(x),
                                            jnp.asarray(idx > p - 1))
    tv, ttau, tbeta = th.householder_vector(t(x), p)
    _close(tv, jv, 1e-14)
    _close(ttau, jtau, 1e-14)
    _close(tbeta, jbeta, 1e-14)


def test_householder_vector_annihilates_the_tail():
    x = rng(7).standard_normal(40) * 1e-20   # prescaling keeps ‖x‖ finite
    v, tau, beta = th.householder_vector(t(x), 3)
    hx = x - float(tau) * n_(v) * (n_(v) @ x)
    np.testing.assert_allclose(hx[4:], 0.0, atol=1e-35)
    np.testing.assert_allclose(hx[3], float(beta), rtol=1e-14)


def test_tridiag_panel_matches_jax():
    b = sym(N, 1)
    ju, jw, jtau, je = jh.tridiag_panel(jnp.asarray(b), 16)
    tu, tw, ttau, te = th.tridiag_panel(t(b), 16)
    _close(tu, ju)
    _close(ttau, jtau)
    _close(te, je)
    _close(th._panel_diag(t(b), tu, tw, 16),
           jh._panel_diag(jnp.asarray(b), ju, jw, 16))


@pytest.mark.parametrize("n", [N, 100])
def test_tridiagonalize_matches_jax(n):
    a = sym(n, 2)
    jr = jh.tridiagonalize(jnp.asarray(a), nb=64)
    ta = t(a)
    tr = th.tridiagonalize(ta, nb=64)
    np.testing.assert_array_equal(n_(ta), a)          # input untouched
    for name in ("d", "e", "v", "tau"):
        _close(getattr(tr, name), getattr(jr, name))


def test_tridiagonalize_donate_reuses_the_input():
    a = t(sym(96, 3))
    ref = th.tridiagonalize(a.clone(), nb=32)
    got = th.tridiagonalize(a, nb=32, donate=True)
    assert not torch.equal(a, t(sym(96, 3)))         # working matrix used
    for name in ("d", "e", "v", "tau"):
        assert torch.equal(getattr(got, name), getattr(ref, name))


def test_wy_t_factor_matches_jax():
    a = sym(N, 4)
    jr = jh.tridiagonalize(jnp.asarray(a), nb=64)
    vb, tb = n_(jr.v)[:, :48], n_(jr.tau)[:48]
    _close(th.wy_t_factor(t(vb), t(tb)),
           jh.wy_t_factor(jnp.asarray(vb), jnp.asarray(tb)))


@pytest.mark.parametrize("nb", [128, 50])
def test_back_transform_matches_jax(nb):
    a = sym(N, 5)
    jr = jh.tridiagonalize(jnp.asarray(a), nb=64)
    z = rng(6).standard_normal((N, 70))
    jz = jtr.back_transform(jnp.asarray(z), jr.v, jr.tau, nb=nb)
    tz = t(z)
    out = ttr.back_transform(tz, t(n_(jr.v)), t(n_(jr.tau)), nb=nb)
    _close(out, jz)
    np.testing.assert_array_equal(n_(tz), z)          # donate=False copies
