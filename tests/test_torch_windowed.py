"""The port's windowed reduction (eigenexa_tpu_torch/ops/householder.py,
``impl="windowed"``) and its two kernels' plain versions against the JAX
package (eigenexa_tpu/ops/householder.py, ops/pallas_kernels.py).

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the real Pallas kernel bodies in interpret mode, as
tests/test_windowed_trd.py does.  Inputs come from
``numpy.random.default_rng(seed)`` and go to both packages.

Tolerances.  Kernels, f32: atol 5e-6·max|ref|, as the JAX package's own
kernel tests (sums of up to 1536 products in another order).

Reduction: the two packages round the same recurrence in another order,
and a tridiagonal is not a forward-stable function of its matrix: the
difference grows down the diagonal (measured here between the JAX
package's own rolled and windowed paths at n = 700, f32: 2e-5 in the first
panel, 1.5e-2 at the end, for max|d| = 3).  So d and e are held
elementwise to 5e-5·max|d| in the first panel and 3e-2·max|d| overall in
f32 (1e-12 and 1e-8 in f64 against the port's rolled path), which catches
a wrong panel or window but not a rounding fault.  What the solver needs is
held tightly: the spectrum of (d, e) (5e-6·‖A‖, the JAX test's bound) and
QᵀAQ = T rebuilt from v and tau (1e-5·‖A‖).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

from _torch_parity import n_, rng, sym, t  # noqa: E402

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu.ops import householder as jh  # noqa: E402
from eigenexa_tpu.ops import pallas_kernels as pk  # noqa: E402
from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402
from eigenexa_tpu_torch.testing import (mat_set,  # noqa: E402
                                        orthogonality_check, residual_check)

TM = tk.WIN_TM


def _sym32(n, seed):
    a = rng(seed).standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


def test_window_granularity_is_the_jax_tile():
    assert tk.WIN_TM == pk._SYMV_TM


# ---------------------------------------------------------------------------
# (a) symv_lower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("mt,t0", [(1, 0), (2, 1), (3, 1)])
def test_symv_lower_matches_jax(mt, t0, nc):
    m, w0 = mt * TM, t0 * TM
    a = _sym32(m, 100 + mt)
    shape = (m,) if nc == 1 else (m, nc)
    x = rng(1).standard_normal(shape).astype(np.float32)
    ref = n_(pk.symv_lower(jnp.asarray(a), jnp.asarray(x), t0=t0,
                           interpret=True))
    before = dict(tk.LAUNCHES)
    q = n_(tk.symv_lower(t(a), t(x), t0=t0))
    assert tk.LAUNCHES == before          # a CPU tensor launches nothing
    assert q.shape == x.shape and q.dtype == np.float32
    np.testing.assert_allclose(q[w0:], ref[w0:],
                               atol=5e-6 * np.abs(ref).max())
    assert np.all(q[:w0] == 0) and np.all(ref[:w0] == 0)


@pytest.mark.parametrize("nc", [1, 3])
def test_symv_lower_reads_only_the_lower_triangle(nc):
    """Garbage above the diagonal, a ragged edge, x live above the window:
    none of it reaches the result (a full matvec would show all three)."""
    m, t0 = 700, 1
    w0 = t0 * TM
    a = sym(m, 5)
    dirty = np.tril(a) + np.triu(rng(6).standard_normal((m, m)) * 1e6, 1)
    dirty[0, m - 1] = np.nan
    x = rng(7).standard_normal((m,) if nc == 1 else (m, nc))
    q = n_(tk.symv_lower(t(dirty), t(x), t0=t0))
    want = a[w0:, w0:] @ x[w0:]
    np.testing.assert_allclose(q[w0:], want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    assert np.all(q[:w0] == 0)


def _column_panel(m, j0, jc, nb, seed):
    """A panel buffer [U | W] (m, 2nb) f32 as the windowed column holds it
    after jc columns from j0: U's column l zero above its pivot j0+l+1, W
    zero above j0, columns jc… not yet filled; and the next v, zero above
    its pivot j0+jc+1."""
    r = rng(seed)
    uw = np.zeros((m, 2 * nb), np.float32)
    for l in range(jc):
        uw[j0 + l + 1:, l] = r.standard_normal(m - j0 - l - 1) / 8
        uw[j0:, nb + l] = r.standard_normal(m - j0) / 8
    v = np.zeros(m, np.float32)
    v[j0 + jc + 1:] = r.standard_normal(m - j0 - jc - 1)
    return uw, v


@pytest.mark.parametrize("t0", [0, 1])
def test_fused_symv_matches_the_jax_column(t0):
    """The plain fused form (the CPU path of the windowed column) against
    the JAX package's column: the Pallas symv in interpret mode, then
    ``q - u @ (w.T @ v) - w @ (u.T @ v)`` over all rows.  Both are zero
    above the window (U and W vanish above j0 >= t0·TM).  f32, tolerance
    5e-6·max|ref| as the symv tests: sums in another order.  A workspace
    handed in is what comes back, with the same values."""
    m, nb, jc = 2 * TM, 64, 40
    w0 = t0 * TM
    j0 = w0 + 8
    a = _sym32(m, 300 + t0)
    uw, v = _column_panel(m, j0, jc, nb, 301 + t0)
    u, w = jnp.asarray(uw[:, :nb]), jnp.asarray(uw[:, nb:])
    jv = jnp.asarray(v)
    ref = n_(pk.symv_lower(jnp.asarray(a), jv, t0=t0, interpret=True)
             - u @ (w.T @ jv) - w @ (u.T @ jv))
    before = dict(tk.LAUNCHES)
    got = n_(tk.symv_lower(t(a), t(v), t0=t0, panel=t(uw), nb=jc))
    assert tk.LAUNCHES == before
    np.testing.assert_allclose(got[w0:], ref[w0:],
                               atol=5e-6 * np.abs(ref).max())
    assert np.all(got[:w0] == 0) and np.all(ref[:w0] == 0)
    ws = tk.symv_workspace(t(a), panel_cols=2 * nb)
    out = tk.symv_lower(t(a), t(v), t0=t0, panel=t(uw), nb=jc, **ws)
    assert out is ws["out"]
    np.testing.assert_array_equal(n_(out), got)


def test_fused_symv_plain_version_keeps_todays_order():
    """The plain fused form is the column's former two lines, on the
    window's rows: the symv, then ``q - U @ (Wᵀ @ v) - W @ (Uᵀ @ v)``
    over all n rows and all filled columns.  f64; the plain form leaves out
    rows and columns that hold zeros, which moves only the rounding
    (1e-14·max|q|)."""
    m, nb, jc, t0 = 700, 16, 9, 1
    j0 = TM + 20
    a = sym(m, 302)
    uw, v = (x.astype(np.float64) for x in _column_panel(m, j0, jc, nb, 303))
    u, w = uw[:, :jc], uw[:, nb:nb + jc]
    q = tk._symv_lower_ref(t(a), t(v), t0)
    want = n_(q - t(u) @ (t(w).T @ t(v)) - t(w) @ (t(u).T @ t(v)))
    got = n_(tk.symv_lower(t(a), t(v), t0=t0, panel=t(uw), nb=jc))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


def test_nan_input_poisons_the_windowed_reduction_as_in_jax():
    """A NaN inside the matrix reaches d and e through the fused matvec
    at the same entries as through the JAX package's column."""
    n = 700
    a = _sym32(n, 304)
    a[600, 650] = a[650, 600] = np.nan
    jr = jh.tridiagonalize(jnp.asarray(a), nb=64, impl="windowed")
    tr = th.tridiagonalize(t(a), nb=64, impl="windowed")
    for name in ("d", "e"):
        got, ref = np.isnan(n_(getattr(tr, name))), np.isnan(
            n_(getattr(jr, name)))
        assert got.any()
        np.testing.assert_array_equal(got, ref)


def test_symv_workspace_and_panel_are_checked():
    b, x = t(sym(600, 35)), t(rng(36).standard_normal(600))
    uw = t(np.zeros((600, 8)))
    with pytest.raises(ValueError, match="one vector"):
        tk.symv_lower(b, t(np.zeros((600, 2))), panel=uw)
    with pytest.raises(ValueError, match="2h"):
        tk.symv_lower(b, x, panel=uw[:, :7])
    with pytest.raises(ValueError, match="nb"):
        tk.symv_lower(b, x, panel=uw, nb=5)
    with pytest.raises(ValueError, match="shaped like"):
        tk.symv_lower(b, x, out=t(np.zeros(599)))
    with pytest.raises(ValueError, match="storage"):
        tk.symv_lower(b, x, out=x)
    assert tk.symv_scratch_numel(600, 1, 1, 8) == 8 + 2 * 2 * 88
    assert tk.symv_workspace(b)["scratch"].numel() == 0   # plain: none


# ---------------------------------------------------------------------------
# (b) rank2k_update_window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t0", [0, 1])
def test_rank2k_update_window_matches_jax(t0):
    m, nb, w0 = 2 * TM, 64, t0 * TM
    r = rng(3)
    b, u, w = (r.standard_normal(s).astype(np.float32)
               for s in ((m, m), (m, nb), (m, nb)))
    ref = n_(pk.rank2k_update_window(jnp.asarray(b), jnp.asarray(u),
                                     jnp.asarray(w), t0=t0, interpret=True))
    tb = t(b)
    out = tk.rank2k_update_window(tb, t(u), t(w), t0=t0)
    assert out is tb                                       # in place
    got = n_(tb)
    np.testing.assert_allclose(got[w0:, w0:], ref[w0:, w0:],
                               atol=5e-6 * np.abs(ref).max())
    # outside the window nothing is written, in either package
    np.testing.assert_array_equal(got[:w0, :], b[:w0, :])
    np.testing.assert_array_equal(got[:, :w0], b[:, :w0])
    np.testing.assert_array_equal(ref[:w0, :], b[:w0, :])


def test_rank2k_update_window_ragged_f64():
    m, nb, w0 = 600, 20, TM
    r = rng(4)
    b, u, w = (r.standard_normal(s) for s in ((m, m), (m, nb), (m, nb)))
    want = b.copy()
    want[w0:, w0:] -= u[w0:] @ w[w0:].T + w[w0:] @ u[w0:].T
    got = n_(tk.rank2k_update_window(t(b), t(u), t(w), t0=1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * nb)
    np.testing.assert_array_equal(got[:w0], b[:w0])


# ---------------------------------------------------------------------------
# (c) tridiagonalize(impl="windowed")
# ---------------------------------------------------------------------------

def _q_from_reflectors(v, tau):
    n = v.shape[0]
    q = np.eye(n)
    for k in reversed(range(n - 1)):
        q -= tau[k] * np.outer(v[:, k], v[:, k] @ q)
    return q


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


@pytest.mark.parametrize("n", [300, 512, 700])
def test_windowed_tridiagonalize_matches_jax(n):
    """n = 300: one group, a short last panel; 512: a whole window; 700:
    two groups, the second at t0 = 1 with stale columns inside it."""
    a = _sym32(n, n)
    jr = jh.tridiagonalize(jnp.asarray(a), nb=64, impl="windowed")
    ta = t(a)
    tr = th.tridiagonalize(ta, nb=64, impl="windowed")
    np.testing.assert_array_equal(n_(ta), a)              # input untouched
    assert tr.v.shape == (n, n) and tr.tau.shape == (n,)
    assert tr.d.shape == (n,) and tr.e.shape == (n - 1,)
    d, e = n_(tr.d).astype(np.float64), n_(tr.e).astype(np.float64)
    dscale = np.abs(n_(jr.d)).max()
    for got, ref in ((d, n_(jr.d)), (e, n_(jr.e))):
        np.testing.assert_allclose(got[:64], ref[:64], rtol=0,
                                   atol=5e-5 * dscale)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * dscale)
    a64 = a.astype(np.float64)
    w_ref = np.linalg.eigvalsh(a64)
    scale = np.abs(w_ref).max()
    w = sla.eigh_tridiagonal(d, e, eigvals_only=True)
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=5e-6 * scale)
    v, tau = n_(tr.v).astype(np.float64), n_(tr.tau).astype(np.float64)
    assert np.all(np.triu(v) == 0)         # column k is zero down to row k
    q = _q_from_reflectors(v, tau)
    np.testing.assert_allclose(q.T @ a64 @ q, _tridiag(d, e), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("n", [300, 700, 1100])
def test_windowed_matches_rolled_f64(n):
    """n = 1100: three groups, the last window starting 76 rows from the
    end, then a 12-column remainder."""
    a = sym(n, 10 + n)
    rr = th.tridiagonalize(t(a), nb=64, impl="rolled")
    wr = th.tridiagonalize(t(a), nb=64, impl="windowed")
    dscale = float(rr.d.abs().max())
    for name in ("d", "e", "tau", "v"):
        got, ref = n_(getattr(wr, name)), n_(getattr(rr, name))
        np.testing.assert_allclose(got[:64], ref[:64], rtol=0,
                                   atol=1e-12 * dscale)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8 * dscale)
    w = sla.eigh_tridiagonal(n_(wr.d), n_(wr.e), eigvals_only=True)
    w_ref = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(w, w_ref, rtol=0,
                               atol=1e-13 * n * np.abs(w_ref).max())


def test_windowed_donate_returns_the_inputs_storage():
    a = t(sym(200, 21))
    ref = th.tridiagonalize(a.clone(), nb=32, impl="windowed")
    got = th.tridiagonalize(a, nb=32, impl="windowed", donate=True)
    assert got.v.data_ptr() == a.data_ptr() and got.v is a
    assert ref.v.data_ptr() != a.data_ptr()
    for name in ("d", "e", "v", "tau"):
        assert torch.equal(getattr(got, name), getattr(ref, name))


def test_window_schedule_matches_jax():
    for n, nb in ((300, 64), (700, 64), (5000, 64), (16384, 64),
                  (1300, 48)):
        group = th._win_group_size(n, nb)
        assert group == jh._round_up(
            max(4 * nb, jh._round_up(n, pk._SYMV_TM) // 8), pk._SYMV_TM)
        assert th._win_schedule(n, nb, group) == jh._win_schedule(n, nb,
                                                                  group)
        groups, _ = th._win_schedule(n, nb, group)
        # every window starts inside the matrix, though n is not padded
        assert all((g * group) // TM * TM <= min(ks) for g, ks in
                   groups.items())


# ---------------------------------------------------------------------------
# (d) eigen_s through the windowed reduction
# ---------------------------------------------------------------------------

def test_eigen_s_windowed_matches_jax(monkeypatch):
    from eigenexa_tpu.runtime import SolverConfig as JConfig
    from eigenexa_tpu.runtime import eigen_init as j_init
    from eigenexa_tpu.solvers.solver import eigen_s as j_eigen_s
    from eigenexa_tpu.testing import matgen as jmat

    n = 520
    monkeypatch.setattr(jh, "TRD_IMPL", "windowed")
    monkeypatch.setattr(th, "TRD_IMPL", "windowed")
    ja, _ = jmat.mat_set(n, 0, dtype=jnp.float32)
    jw, _, _ = j_eigen_s(ja, ctx=j_init(config=JConfig(panel_forward=64,
                                                       panel_backward=64)))
    a, w_true = mat_set(n, 0, dtype=torch.float32)
    np.testing.assert_array_equal(n_(a), n_(ja))
    ctx = ext.eigen_init("cpu", config=ext.SolverConfig(panel_forward=64,
                                                        panel_backward=64))
    calls = []
    real = th._Windowed
    monkeypatch.setattr(th, "_Windowed",
                        lambda *args: calls.append(1) or real(*args))
    w, z, _ = ext.eigen_s(a, ctx=ctx)
    ext.eigen_free(ctx)
    assert calls == [1]                      # the solve took this path
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    w_ref = np.linalg.eigvalsh(n_(a).astype(np.float64))
    scale = np.abs(w_ref).max()
    assert np.abs(n_(w) - w_ref).max() < 1e-5 * scale     # the JAX test's bar
    assert np.abs(n_(w) - n_(jw)).max() < 1e-5 * scale
    assert np.abs(n_(w) - n_(w_true)).max() < 1e-5 * scale


# ---------------------------------------------------------------------------
# (e) dispatch, and what the wrappers refuse
# ---------------------------------------------------------------------------

def test_eigen_s_auto_is_rolled(monkeypatch):
    """On a CPU tensor the memory rule never applies: "auto" is rolled, and
    only ``TRD_IMPL`` or ``impl`` force the other (the rule itself:
    tests/test_torch_chunked.py)."""
    def boom(*args):
        raise AssertionError("windowed path taken")

    monkeypatch.setattr(th, "_Windowed", boom)
    assert th.TRD_IMPL == "auto"
    a, _ = mat_set(96, 0, dtype=torch.float64)
    ctx = ext.eigen_init("cpu", config=ext.SolverConfig(panel_forward=32,
                                                        panel_backward=32))
    w, z, _ = ext.eigen_s(a, ctx=ctx)
    assert residual_check(a, z, w).passed
    monkeypatch.setattr(th, "TRD_IMPL", "windowed")
    with pytest.raises(AssertionError, match="windowed path taken"):
        ext.eigen_s(a, ctx=ctx)
    ext.eigen_free(ctx)


def test_auto_on_a_cpu_tensor_is_rolled(monkeypatch):
    def boom(*args):
        raise AssertionError("windowed path taken")

    monkeypatch.setattr(th, "_Windowed", boom)
    assert th.TRD_IMPL == "auto"
    a = t(sym(96, 30))
    r = th.tridiagonalize(a, nb=32)
    assert r.v.data_ptr() != a.data_ptr()
    monkeypatch.setattr(th, "TRD_IMPL", "windowed")
    with pytest.raises(AssertionError, match="windowed path taken"):
        th.tridiagonalize(a, nb=32)
    th.tridiagonalize(a, nb=32, impl="rolled")      # an explicit impl wins
    with pytest.raises(ValueError, match="unknown impl"):
        th.tridiagonalize(a, nb=32, impl="fused")


def test_windowed_refuses_complex():
    a = t(sym(16, 31)).to(torch.complex128)
    with pytest.raises(NotImplementedError, match="real only"):
        th.tridiagonalize(a, impl="windowed")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    b, x = t(sym(8, 32)), t(rng(33).standard_normal(8))
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="outside"):
        tk.symv_lower(t(sym(TM, 34)), t(np.zeros(TM)), t0=1)   # t0·TM = m
    with pytest.raises(ValueError, match="outside"):
        tk.rank2k_update_window(b, b[:, :2], b[:, :2], t0=1)
    with pytest.raises(ValueError, match="square"):
        tk.symv_lower(b[:, :4], x)
    with pytest.raises(ValueError, match="does not fit"):
        tk.symv_lower(b, x[:5])
    with pytest.raises(ValueError, match="vectors"):
        tk.symv_lower(b, t(np.zeros((8, tk.SYMV_MAX_NC + 1))))
    with pytest.raises(TypeError):
        tk.symv_lower(b, x.float())
    with pytest.raises(ValueError, match="do not fit"):
        tk.rank2k_update_window(b, b[:, :2], b[:, :3])
    with pytest.raises(TypeError):
        tk.rank2k_update_window(b, b[:, :2].float(), b[:, :2].float())
    # a device that is neither CPU nor CUDA has no plain fallback, and the
    # dtype faults are told apart before the device is
    for call in (lambda d: tk.symv_lower(_meta(8, 8, dtype=d),
                                         _meta(8, dtype=d)),
                 lambda d: tk.rank2k_update_window(_meta(8, 8, dtype=d),
                                                   _meta(8, 2, dtype=d),
                                                   _meta(8, 2, dtype=d))):
        with pytest.raises(NotImplementedError, match="device"):
            call(torch.float32)
        with pytest.raises(NotImplementedError, match="real only"):
            call(torch.complex64)
        with pytest.raises(TypeError, match="dtype"):
            call(torch.float16)
    assert tk.LAUNCHES == before
