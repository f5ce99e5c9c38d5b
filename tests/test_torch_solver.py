"""Port ``eigen_s`` (eigenexa_tpu_torch/solvers/solver.py) against the JAX
package's ``eigen_s``: the slice as a whole, at n=192 on the CPU.

w is compared to a dtype-relative tolerance: 1e-12·‖A‖ when the solve is
f64, 1e-4·‖A‖ when it is f32 (both return f64 values from the f64 D&C,
but the f32 reductions round differently).  Z is compared through the
reference's acceptance checks and the eigenvalue-cluster projectors, never
raw (column signs are free).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same_eigenspaces, n_, sym, t  # noqa: E402

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu.runtime import SolverConfig as JaxConfig  # noqa: E402
from eigenexa_tpu.solvers.solver import eigen_s as j_eigen_s  # noqa: E402
from eigenexa_tpu.testing.matgen import frank as j_frank  # noqa: E402
from eigenexa_tpu_torch.interop import (as_tensor,  # noqa: E402
                                        config_from_jax, to_numpy)
from eigenexa_tpu_torch.solvers import solver as tsolver  # noqa: E402
from eigenexa_tpu_torch.testing import (eigenvalue_check,  # noqa: E402
                                        frank, frank_spectrum,
                                        orthogonality_check, residual_check)

REPO = Path(__file__).resolve().parent.parent
N = 192
W_TOL = {np.float64: 1e-12, np.float32: 1e-4}


def _both(a_np, **kw):
    jw, jz, _ = j_eigen_s(jnp.asarray(a_np), **kw)
    w, z, info = ext.eigen_s(t(a_np), **kw)
    return (n_(jw), n_(jz)), (w, z, info)


@pytest.mark.parametrize("case,dtype", [("frank", np.float64),
                                        ("random", np.float64),
                                        ("random", np.float32)])
def test_eigen_s_matches_jax(case, dtype):
    a = (n_(j_frank(N, jnp.float64)) if case == "frank" else sym(N, 7))
    a = a.astype(dtype)
    (jw, jz), (w, z, info) = _both(a)
    assert w.dtype == torch.float64 and z.dtype == t(a).dtype
    assert z.shape == (N, N) and info.n == N and info.nvec == N
    scale = np.abs(jw).max()
    assert np.abs(n_(w) - jw).max() < W_TOL[dtype] * scale
    ta = t(a)
    assert residual_check(ta, z, w).passed
    assert orthogonality_check(z).passed
    if dtype == np.float64:
        assert_same_eigenspaces(z, jz, w, tol=1e-8, gap=1e-8 * scale)
    if case == "frank":
        assert eigenvalue_check(w, frank_spectrum(N)).passed


@pytest.mark.parametrize("mode", ["T", "S", "C"])
def test_stage_isolation_modes_match_jax(mode):
    a = sym(64, 8)
    (jw, jz), (w, z, info) = _both(a, mode=mode)
    assert info.mode == mode and z.shape == (64, 64)
    np.testing.assert_allclose(n_(w), jw, rtol=0,
                               atol=1e-12 * np.abs(jw).max())
    if mode == "C":
        np.testing.assert_array_equal(n_(z), np.eye(64))
    elif mode == "S":            # Z = Q: the reduction's orthogonal factor
        np.testing.assert_allclose(n_(z), jz, atol=1e-12)
    else:                        # Z = eigenvectors of T
        assert_same_eigenspaces(z, jz, w, tol=1e-9, gap=1e-8)
    # T and S compose to mode A
    if mode == "T":
        _, zq, _ = ext.eigen_s(t(a), mode="S")
        _, za, _ = ext.eigen_s(t(a), mode="A")
        assert_same_eigenspaces(zq @ z, za, w, tol=1e-9, gap=1e-8)


def test_profile_path_reports_the_stage_split():
    a = t(sym(96, 9))
    w0, z0, _ = ext.eigen_s(a)
    w, z, info = ext.eigen_s(a, profile=True)
    assert list(info.stages) == ["TRD-BLK", "D&C", "TRDBAK"]
    assert all(r["seconds"] > 0 and r["flops"] > 0
               for r in info.stages.values())
    assert torch.equal(w, w0) and torch.equal(z, z0)
    lines = []
    info.stage_report(lines.append)
    assert len(lines) == 4 and info.gflops > 0
    assert info.flops == tsolver.flop_model(96, 96, True)


def test_repeated_solves_are_bitwise_equal_and_keep_the_input():
    a = frank(128, torch.float32)
    keep = a.clone()
    w1, z1, _ = ext.eigen_s(a)
    w2, z2, _ = ext.eigen_s(a)
    assert torch.equal(a, keep)
    assert torch.equal(w1, w2) and torch.equal(z1, z2)


def test_nvec_selects_the_lowest_eigenvectors():
    a = sym(N, 10)
    w, z, info = ext.eigen_s(t(a), nvec=20)
    assert z.shape == (N, 20) and w.shape == (N,) and info.nvec == 20
    assert residual_check(t(a), z, w, nvec=20).passed
    wf, zf, _ = ext.eigen_s(t(a))
    assert_same_eigenspaces(z, zf[:, :20], w[:20], tol=1e-9, gap=1e-8)


def test_bad_and_unported_modes_raise():
    """Every mode of the reference is ported (N, X and R since the band-2
    slice); a mode outside them raises ValueError naming it, in both
    drivers."""
    a = t(sym(16, 11))
    assert tsolver._PORTED_MODES == tsolver.MODES
    for driver in (ext.eigen_s, ext.eigen_sx):
        for mode in ("Q", "Z", "AN"):
            with pytest.raises(ValueError, match=f"'{mode}'"):
                driver(a, mode=mode)


def test_nan_input_poisons_w():
    a = sym(32, 12)
    a[3, 4] = a[4, 3] = np.nan
    w, z, _ = ext.eigen_s(t(a))
    assert torch.isnan(w).all()
    # matrix_scaling alone: sigma is NaN, no exception
    _, sigma = tsolver.matrix_scaling(t(a))
    assert torch.isnan(sigma)


@pytest.mark.parametrize("scale", [1e-200, 1.0, 1e200])
def test_matrix_scaling_matches_jax(scale):
    from eigenexa_tpu.solvers.solver import matrix_scaling as j_scaling

    a = sym(8, 13) * scale
    ja, js = j_scaling(jnp.asarray(a))
    ta, ts = tsolver.matrix_scaling(t(a))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(n_(ta), n_(ja))


def test_numpy_input_and_interop():
    a = sym(48, 14)
    ctx = ext.eigen_init("cpu")
    w, z, _ = ext.eigen_s(a, ctx=ctx)
    assert isinstance(z, torch.Tensor) and z.device.type == "cpu"
    assert residual_check(as_tensor(a), z, w).passed
    np.testing.assert_array_equal(to_numpy(as_tensor(a)), a)
    w2, z2 = ext.eigh(a, ctx=ctx)
    assert torch.equal(w, w2) and torch.equal(z, z2)
    ext.eigen_free(ctx)


def test_default_context_is_the_card_and_never_the_cpu():
    """eigen_init() names the CUDA card whether or not there is one, and
    building it needs none; a numpy input then goes to the card, so on a
    machine without one the solve raises instead of running on the CPU.
    A CPU tensor still solves on its own device."""
    if torch.cuda.is_available():
        pytest.skip("shows the behaviour of a machine without a card")
    ctx = ext.eigen_init()
    try:
        assert ctx.device.type == "cuda"
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ext.eigen_s(sym(16, 16))
        w, z, _ = ext.eigen_s(t(sym(16, 16)))
        assert w.device.type == "cpu" and z.device.type == "cpu"
    finally:
        ext.eigen_free(ctx)


@pytest.mark.parametrize("n", [192, 8192])
def test_frank_spectrum_matches_jax_and_loses_no_digits(n):
    """The port's Frank spectrum is the JAX package's up to the JAX
    formula's cancellation, and within 4ε (relative) of the same values in
    extended precision.  (The JAX package's 1/(2(1 − cos θ)) was measured
    1.6e-9 relative off at n = 8192 on the largest eigenvalue; only the
    agreement is bounded here, not that error.)"""
    from eigenexa_tpu.testing.matgen import frank_spectrum as j_spectrum

    w = frank_spectrum(n).numpy()
    i = np.arange(1, n + 1, dtype=np.longdouble)
    theta = np.pi * (2 * (n - i) + 1) / (2 * n + 1)
    exact = 0.25 / np.sin(theta / 2) ** 2
    eps = np.finfo(np.float64).eps
    assert np.all(np.diff(w) > 0)
    assert float(np.max(np.abs((w - exact) / exact))) < 4 * eps
    jw = n_(j_spectrum(n))
    rel = np.abs(jw - w) / w
    assert float(rel.max()) < (1e-11 if n == 192 else 4e-9)


def test_config_from_jax():
    jcfg = JaxConfig(panel_forward=32, panel_backward=64, use_pallas=False,
                     matmul_precision="high")
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, ext.SolverConfig)
    assert dataclasses.asdict(cfg) == {"panel_forward": 32,
                                       "panel_backward": 64,
                                       "matmul_precision": "high"}
    assert config_from_jax(JaxConfig()) == ext.SolverConfig()
    cfg = dataclasses.replace(cfg, matmul_precision="highest")
    # the config's panels drive the solve
    a = t(sym(80, 15))
    ctx = ext.eigen_init("cpu", config=cfg)
    w, z, _ = ext.eigen_s(a, ctx=ctx)
    assert residual_check(a, z, w).passed
    ext.eigen_free(ctx)


def test_flop_models_match_jax():
    from eigenexa_tpu.solvers import solver as js

    for n in (1, 192, 8192):
        assert tsolver.dc_flop_model(n) == js.dc_flop_model(n)
        assert tsolver.flop_model(n, n, True) == js.flop_model(n, n, True)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py never falls back to the CPU: here (no card) it must
    exit non-zero and print no result line."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
