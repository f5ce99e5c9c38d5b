"""Port ``eigen_h`` (eigenexa_tpu_torch/solvers/hermitian.py) and the
complex rolled reduction against the JAX package's native complex
``eigen_h`` on the CPU, c64 and c128, at n = 96 (one full panel of 64 and a
remainder) and n = 100 with panels of 16.

Tolerances, relative to ‖A‖ = max|w|: w 1e-12 in c128 and 1e-4 in c64 (the
D&C returns f64 values, but the reductions round in another order); modes S
and C return T's diagonal, where two correct reductions drift apart by the
reduction's backward error, so 1e-10 and 1e-3 (ROADMAP C).  Vectors are
held through the reference's checks and, on a spectrum with unit gaps, by
|z_portᴴ·z_jax| = 1 column by column within 1e-10 (c128) and 1e-4 (c64):
complex eigenvectors are fixed only up to a unit phase.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_, rng, t  # noqa: E402

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu.ops import householder as jh  # noqa: E402
from eigenexa_tpu.solvers.hermitian import eigen_h as j_eigen_h  # noqa: E402
from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.solvers import solver as tsolver  # noqa: E402
from eigenexa_tpu_torch.solvers import trbak as ttr  # noqa: E402
from eigenexa_tpu_torch.testing import (frank_hermitian,  # noqa: E402
                                        frank_spectrum, orthogonality_check,
                                        residual_check)

N = 96
DTYPES = [np.complex64, np.complex128]
W_TOL = {np.complex64: 1e-4, np.complex128: 1e-12}
D_TOL = {np.complex64: 1e-3, np.complex128: 1e-10}
PHASE_TOL = {np.complex64: 1e-4, np.complex128: 1e-10}


def herm(n: int, seed: int, dtype) -> np.ndarray:
    """Q·diag(1, 2, …, n)·Qᴴ with Q unitary from a complex Gaussian's QR:
    Hermitian, genuinely complex, every eigenvalue gap 1."""
    r = rng(seed)
    q, _ = np.linalg.qr(r.standard_normal((n, n))
                        + 1j * r.standard_normal((n, n)))
    a = (q * np.arange(1.0, n + 1.0)) @ q.conj().T
    return (0.5 * (a + a.conj().T)).astype(dtype)


@pytest.fixture(scope="module")
def solves():
    """One JAX eigen_h a (dtype, mode), shared by the module's tests."""
    cache = {}

    def get(dtype, mode="A"):
        if (dtype, mode) not in cache:
            a = herm(N, 3, dtype)
            w, z, _ = j_eigen_h(jnp.asarray(a), mode=mode)
            cache[dtype, mode] = (a, n_(w), None if z is None else n_(z))
        return cache[dtype, mode]
    return get


@pytest.mark.parametrize("dtype", DTYPES)
def test_tridiagonalize_matches_jax(dtype):
    """d and e real; |e| equal (the phases are zlarfg's on both sides); d
    within the reduction's drift; Q·T·Qᴴ = A with Q the back-transform of
    the identity, within the residual check's scale (n·ε·‖A‖)."""
    a = herm(N, 5, dtype)
    jr = jh.tridiagonalize(jnp.asarray(a), nb=32)
    tr = th.tridiagonalize(t(a), nb=32)
    rdt = torch.float32 if dtype == np.complex64 else torch.float64
    assert tr.d.dtype == rdt and tr.e.dtype == rdt
    assert tr.v.dtype == t(a).dtype and tr.tau.dtype == t(a).dtype
    scale = np.abs(a).max()
    tol = D_TOL[dtype] * scale
    assert np.abs(n_(tr.d) - n_(jr.d)).max() < tol
    assert np.abs(np.abs(n_(tr.e)) - np.abs(n_(jr.e))).max() < tol
    q = ttr.back_transform(torch.eye(N, dtype=tr.v.dtype), tr.v, tr.tau,
                           nb=32)
    tt = (torch.diag(tr.d) + torch.diag(tr.e, 1)
          + torch.diag(tr.e, -1)).to(q.dtype)
    eps = torch.finfo(q.dtype).eps
    back = float((q @ tt @ q.conj().T - t(a)).abs().max())
    assert back < 10 * N * eps * scale, back


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_last_column_rotates_the_phase(n, dtype):
    """The last sub-diagonal of a 2×2 or 3×3 input is complex: its
    reflector has an empty tail and must still rotate the phase into Q, so
    that e is real and Q·T·Qᴴ = A (the back-transform covers n − 1
    reflectors); e equals JAX's."""
    a = np.diag(np.arange(1.0, n + 1.0)).astype(dtype)
    a[n - 1, n - 2] = 0.6 + 0.8j
    a[n - 2, n - 1] = 0.6 - 0.8j
    if n == 3:
        a[2, 0], a[0, 2] = 0.3 - 0.2j, 0.3 + 0.2j
    tr = th.tridiagonalize(t(a))
    jr = jh.tridiagonalize(jnp.asarray(a))
    assert tr.tau[n - 2] != 0
    tol = 1e-6 if dtype == np.complex64 else 1e-14
    np.testing.assert_allclose(n_(tr.e), n_(jr.e), atol=tol)
    np.testing.assert_allclose(n_(tr.d), n_(jr.d), atol=tol)
    q = ttr.back_transform(torch.eye(n, dtype=tr.v.dtype), tr.v, tr.tau)
    tt = (torch.diag(tr.d) + torch.diag(tr.e, 1)
          + torch.diag(tr.e, -1)).to(q.dtype)
    np.testing.assert_allclose(n_(q @ tt @ q.conj().T), a, atol=tol)
    w, z, _ = ext.eigen_h(t(a))
    assert residual_check(t(a), z, w).passed
    np.testing.assert_allclose(n_(w), np.linalg.eigvalsh(a.astype(
        np.complex128)), atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eigen_h_matches_jax_and_numpy(solves, dtype):
    """Mode A: w against JAX's eigen_h and numpy's eigvalsh; Z through the
    checks and column by column against JAX's up to a unit phase."""
    a, jw, jz = solves(dtype)
    w, z, info = ext.eigen_h(t(a))
    assert w.dtype == torch.float64 and z.dtype == t(a).dtype
    assert z.shape == (N, N) and info.n == N and info.mode == "A"
    scale = np.abs(jw).max()
    assert np.abs(n_(w) - jw).max() < W_TOL[dtype] * scale
    npw = np.linalg.eigvalsh(a.astype(np.complex128))
    assert np.abs(n_(w) - npw).max() < W_TOL[dtype] * scale
    assert residual_check(t(a), z, w).value < 768
    assert orthogonality_check(z).value < 8
    phase = np.abs(np.sum(n_(z).conj() * jz, axis=0))
    assert np.abs(phase - 1).max() < PHASE_TOL[dtype]
    assert info.flops == 4.0 * tsolver.flop_model(N, N, True)


@pytest.mark.parametrize("mode", ["N", "X", "T", "S", "C"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_modes_match_jax(solves, dtype, mode):
    """w within its mode's tolerance of JAX's; Z of the mode's shape and
    dtype; X with the checks, T with the real vectors of T, S with
    orthonormal columns (Q itself)."""
    a, jw, jz = solves(dtype, mode)
    w, z, _ = ext.eigen_h(t(a), mode=mode)
    scale = np.abs(solves(dtype)[1]).max()
    tol = (D_TOL if mode in "SC" else W_TOL)[dtype]
    assert np.abs(n_(w) - jw).max() < tol * scale
    if mode == "N":
        assert z is None and jz is None
        return
    assert z.shape == (N, N) and z.dtype == t(a).dtype
    if mode == "X":
        assert residual_check(t(a), z, w).passed
    if mode == "T":
        assert not bool(z.imag.any())
        np.testing.assert_allclose(np.abs(n_(z)), np.abs(jz),
                                   atol=PHASE_TOL[dtype] * 10)
    if mode in "XTS":
        assert orthogonality_check(z).passed
    if mode == "C":
        assert torch.equal(z, torch.eye(N, dtype=z.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mode_x_is_mode_a_and_mode_n_agrees(dtype):
    """Mode X does not refine (as in the JAX package): bitwise mode A.
    Mode N (eigvalsh of T) within the w tolerance of mode A.  Two runs of
    mode A are bitwise equal."""
    a = t(herm(N, 7, dtype))
    wa, za, _ = ext.eigen_h(a)
    wx, zx, _ = ext.eigen_h(a, mode="X")
    assert torch.equal(wa, wx) and torch.equal(za, zx)
    wa2, za2, _ = ext.eigen_h(a)
    assert torch.equal(wa, wa2) and torch.equal(za, za2)
    wn, _, _ = ext.eigen_h(a, mode="N")
    scale = float(wa.abs().max())
    assert float((wn.double() - wa).abs().max()) < W_TOL[dtype] * scale


def test_bad_inputs_raise_and_real_input_is_cast():
    a = herm(16, 9, np.complex128)
    with pytest.raises(ValueError, match="unknown mode"):
        ext.eigen_h(t(a), mode="R")
    with pytest.raises(NotImplementedError, match="A13"):
        ext.eigen_h((t(a.real), t(a.imag)))
    s = np.asarray(a.real + a.real.T)
    for dtype, cdtype in ((torch.float64, torch.complex128),
                          (torch.float32, torch.complex64)):
        w, z, _ = ext.eigen_h(t(s, dtype))
        assert z.dtype == cdtype
        ws, _, _ = ext.eigen_s(t(s, dtype))
        tol = 1e-12 if dtype == torch.float64 else 1e-4
        assert float((w - ws).abs().max()) < tol * float(ws.abs().max())


def test_nan_input_poisons_w():
    a = herm(16, 11, np.complex128)
    a[3, 5] = np.nan
    w, _, _ = ext.eigen_h(t(a))
    assert bool(torch.isnan(w).all())


@pytest.mark.parametrize("dtype,big", [(np.complex64, 1e30),
                                       (np.complex128, 1e300)])
def test_matrix_scaling_on_complex_input(dtype, big):
    """σ and ‖A‖ are real and ε is the real dtype's: σ equals the JAX
    package's on the same large input, the scaled matrix is finite, and a
    non-finite entry poisons σ."""
    from eigenexa_tpu.solvers.solver import matrix_scaling as j_scaling

    a = herm(8, 13, np.complex128) * big
    a = a.astype(dtype)
    a_s, sigma = tsolver.matrix_scaling(t(a))
    assert not sigma.is_complex() and a_s.dtype == t(a).dtype
    assert bool(torch.isfinite(a_s).all()) and float(sigma) < 1.0
    jsigma = np.real(n_(j_scaling(jnp.asarray(a))[1]))
    np.testing.assert_allclose(float(sigma), jsigma, rtol=1e-6)
    a = t(herm(8, 13, dtype))
    assert float(tsolver.matrix_scaling(a)[1]) == 1.0
    a[0, 1] = complex(np.inf, 0.0)
    assert bool(torch.isnan(tsolver.matrix_scaling(a)[1]))


def test_profile_fills_the_stage_split_with_panels_of_16():
    """n = 100 with panels of 16 in both directions: six full panels and a
    remainder; the profiled solve passes the checks and reports the three
    stages; Frank's spectrum under the phase similarity."""
    ctx = ext.EigenContext(config=ext.SolverConfig(panel_forward=16,
                                                   panel_backward=16),
                           device=torch.device("cpu"))
    a = frank_hermitian(100)
    w, z, info = ext.eigen_h(a, ctx=ctx, profile=True)
    assert list(info.stages) == ["TRD-BLK", "D&C", "TRDBAK"]
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    wt = frank_spectrum(100)
    assert float((w - wt).abs().max()) < 1e-12 * float(wt.max())
    _, _, info_n = ext.eigen_h(a, mode="N", ctx=ctx, profile=True)
    assert list(info_n.stages) == ["TRD-BLK", "EIGVALSH"]
