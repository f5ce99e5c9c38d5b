"""Port Sturm bisection (eigenexa_tpu_torch/ops/sturm.py and the plain
version of kernels.sturm_bisect) against the JAX package's
eigenexa_tpu/ops/sturm.py, on the CPU at n ≤ 256.

Counts are integers and must be equal.  Eigenvalues from bisection and
refinement are compared to 1e-12·max(1, ‖T‖): both take the same midpoints
in the same order, and the bound leaves room for a rounding of the
Gershgorin bounds or the refinement brackets that XLA takes otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_, rng, t  # noqa: E402

from eigenexa_tpu.ops import sturm as js  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402
from eigenexa_tpu_torch.ops import sturm as ts  # noqa: E402


def _bands(n, seed, band2):
    g = rng(seed)
    d, e1 = g.standard_normal(n), g.standard_normal(max(n - 1, 0))
    e2 = g.standard_normal(max(n - 2, 0)) if band2 else None
    return d, e1, e2


def _dense(d, e1, e2):
    a = np.diag(d) + np.diag(e1, 1) + np.diag(e1, -1)
    if e2 is not None:
        a += np.diag(e2, 2) + np.diag(e2, -2)
    return a


def _tol(d, e1, e2):
    return 1e-12 * max(1.0, np.abs(np.linalg.eigvalsh(_dense(d, e1, e2)))
                       .max())


# the JAX band-2 scan needs n ≥ 2
@pytest.mark.parametrize("n,band2", [(1, False), (2, False), (3, False),
                                     (57, False), (256, False), (2, True),
                                     (3, True), (57, True), (256, True)])
def test_sturm_counts_equal_jax(n, band2):
    """Band 1: equal to JAX's counts at every probe.  Band 2: equal to
    JAX's at every probe but at most one, where the port's count is the
    true inertia (numpy's eigenvalues) and JAX's is not.  The band-2
    elimination has no
    pivoting, so one rounding can flip a pivot's sign where the elements
    grow; XLA on the CPU contracts c − l1·b into an fma, the port (and the
    card's kernel) rounds each operation once.  At n = 256 one probe of 46
    (x = −0.2892, 7.7e-4 from the nearest eigenvalue) reads 116 in JAX
    against the true 117."""
    d, e1, e2 = _bands(n, 100 + n, band2)
    x = np.concatenate([rng(n).standard_normal(40) * 3, d[:5], [0.0]])
    if band2:
        want = js.sturm_count_band2(*(jnp.asarray(v) for v in (d, e1, e2, x)))
        got = ts.sturm_count_band2(t(d), t(e1), t(e2), t(x))
    else:
        want = js.sturm_count(jnp.asarray(d), jnp.asarray(e1), jnp.asarray(x))
        got = ts.sturm_count(t(d), t(e1), t(x))
    assert got.dtype == torch.int32
    got, want = n_(got), n_(want)
    if not band2:
        np.testing.assert_array_equal(got, want)
        return
    truth = (np.linalg.eigvalsh(_dense(d, e1, e2))[None, :]
             < x[:, None]).sum(axis=1)
    differ = got != want
    assert differ.sum() <= 1
    np.testing.assert_array_equal(got[differ], truth[differ])


def test_counts_hold_the_pivmin_guard_on_exact_zeros():
    """Integer bands probed at their own diagonal entries: pivots meet 0
    exactly, and the clamp must count them as JAX does."""
    d = np.array([2.0, 2.0, -1.0, 0.0, 3.0, 2.0, 1.0, 1.0])
    e1 = np.array([0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 1.0])
    e2 = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 1.0])
    x = np.unique(np.concatenate([d, d + 1, [-3.0, 0.5, 5.0]]))
    for got, want in (
            (ts.sturm_count(t(d), t(e1), t(x)),
             js.sturm_count(jnp.asarray(d), jnp.asarray(e1), jnp.asarray(x))),
            (ts.sturm_count_band2(t(d), t(e1), t(e2), t(x)),
             js.sturm_count_band2(*(jnp.asarray(v)
                                    for v in (d, e1, e2, x))))):
        np.testing.assert_array_equal(n_(got), n_(want))


@pytest.mark.parametrize("band2", [False, True])
def test_gershgorin_bounds_equal_jax(band2):
    d, e1, e2 = _bands(40, 7, band2)
    if band2:
        got = ts.gershgorin_bounds_band2(t(d), t(e1), t(e2))
        want = js.gershgorin_bounds_band2(*(jnp.asarray(v)
                                            for v in (d, e1, e2)))
    else:
        got = ts.gershgorin_bounds(t(d), t(e1))
        want = js.gershgorin_bounds(jnp.asarray(d), jnp.asarray(e1))
    assert [float(v) for v in got] == [float(v) for v in want]


@pytest.mark.parametrize("n,band2", [(1, False), (5, False), (200, False),
                                     (2, True), (5, True), (200, True)])
def test_bisection_matches_jax(n, band2):
    d, e1, e2 = _bands(n, 300 + n, band2)
    if band2:
        got = ts.eigvals_bisect_band2(t(d), t(e1), t(e2))
        want = js.eigvals_bisect_band2(*(jnp.asarray(v)
                                         for v in (d, e1, e2)))
    else:
        got = ts.eigvals_bisect(t(d), t(e1))
        want = js.eigvals_bisect(jnp.asarray(d), jnp.asarray(e1))
    assert got.dtype == torch.float64 and got.shape == (n,)
    tol = _tol(d, e1, e2)
    np.testing.assert_allclose(n_(got), n_(want), rtol=0, atol=tol)
    np.testing.assert_allclose(n_(got),
                               np.linalg.eigvalsh(_dense(d, e1, e2)),
                               rtol=0, atol=100 * tol)


@pytest.mark.parametrize("band2", [False, True])
def test_refinement_matches_jax_and_keeps_w0_where_a_bracket_fails(band2):
    n = 120
    d, e1, e2 = _bands(n, 17, band2)
    w_true = np.linalg.eigvalsh(_dense(d, e1, e2))
    w0 = w_true + 1e-9 * rng(18).standard_normal(n)
    w0[7] = w_true[7] + 50.0      # a bracket that cannot hold index 7
    if band2:
        got = ts.refine_eigenvalues_band2(t(d), t(e1), t(e2), t(w0))
        want = js.refine_eigenvalues_band2(*(jnp.asarray(v)
                                             for v in (d, e1, e2, w0)))
    else:
        got = ts.refine_eigenvalues(t(d), t(e1), t(w0))
        want = js.refine_eigenvalues(*(jnp.asarray(v) for v in (d, e1, w0)))
    got, want = n_(got), n_(want)
    assert got[7] == w0[7] == want[7]
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(d, e1, e2))
    keep = np.arange(n) != 7
    assert np.abs(got[keep] - w_true[keep]).max() < 1e-12 * 10


@pytest.mark.parametrize("band2", [False, True])
def test_plain_version_on_an_index_subset_gives_the_same_bits(band2):
    """Each index's bracket evolves alone: the plain version on a subset of
    the indices equals the whole, bit for bit (what the card script uses
    at n = 8192, where the whole plain loop is too long)."""
    d, e1, e2 = (t(v) if v is not None else None
                 for v in _bands(90, 23, band2))
    a0 = torch.full((90,), -20.0, dtype=torch.float64)
    b0 = torch.full((90,), 20.0, dtype=torch.float64)
    w0 = torch.linspace(-3.0, 3.0, 90, dtype=torch.float64)
    idx = torch.tensor([0, 1, 44, 89])
    for valid in (False, True):
        whole = tk.sturm_bisect(d, e1, e2, a0, b0, 30, valid, w0)
        part = tk._sturm_bisect_ref(d, e1, e2, a0, b0, 30, valid, w0,
                                    idx=idx)
        assert torch.equal(whole[idx], part)


def test_sturm_bisect_checks_its_operands_and_devices():
    d, e1 = (t(v) for v in _bands(10, 3, False)[:2])
    a0, b0 = -torch.ones(10, dtype=torch.float64), torch.ones(10)
    with pytest.raises(ValueError, match="bands"):
        tk.sturm_bisect(d, e1[:-1], None, a0, b0, 4)
    with pytest.raises(ValueError, match="w0"):
        tk.sturm_bisect(d, e1, None, a0, b0, 4, check_valid=True)
    with pytest.raises(ValueError, match=r"\(10,\)"):
        tk.sturm_bisect(d, e1, None, a0[:9], b0, 4)
    meta = [torch.empty(s, device="meta") for s in ((10,), (9,), (10,),
                                                    (10,))]
    with pytest.raises(NotImplementedError, match="meta"):
        tk.sturm_bisect(meta[0], meta[1], None, meta[2], meta[3], 4)
    # counts alone never run as an eager loop off the CPU
    with pytest.raises(NotImplementedError, match="sturm_bisect"):
        ts.sturm_count(meta[0], meta[1], meta[2])
