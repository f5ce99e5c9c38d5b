"""Port drivers ``eigen_s`` and ``eigen_sx`` (eigenexa_tpu_torch/solvers/
solver.py) in all seven modes against the JAX package's drivers, on the CPU.

The JAX side runs with profile=True: its staged path compiles each stage
once, where the fused path compiles a program a mode.  n = 100 with the
default panels of 64: one full panel and the remainder.  w is compared as
in test_torch_solver.py: 1e-12·‖A‖ when the solve is f64, 1e-4·‖A‖ when it
is f32 (both return f64 values; the f32 reductions round otherwise).  Z
is held to the reference's checks and compared through the projectors of
the eigenvalue clusters, never raw (column signs are free).  Modes S and
C return the reduction's diagonal, held as test_torch_band.py holds the
bands: 1e-10·‖A‖ in f64, 50·n·ε·‖A‖ in f32 (two correct f32 reductions
drift apart by about that much).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same_eigenspaces, n_, sym, t  # noqa: E402

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu.solvers import solver as js  # noqa: E402
from eigenexa_tpu_torch.ops import band as tb  # noqa: E402
from eigenexa_tpu_torch.ops.householder import tridiagonalize  # noqa: E402
from eigenexa_tpu_torch.solvers import solver as tsolver  # noqa: E402
from eigenexa_tpu_torch.solvers.dc import assemble_tridiag  # noqa: E402
from eigenexa_tpu_torch.testing import (orthogonality_check,  # noqa: E402
                                        residual_check)

N = 100
W_TOL = {np.float64: 1e-12, np.float32: 1e-4}
D_TOL = {np.float64: 1e-10,
         np.float32: 50 * N * float(np.finfo(np.float32).eps)}
DRIVERS = {"eigen_s": (ext.eigen_s, js.eigen_s),
           "eigen_sx": (ext.eigen_sx, js.eigen_sx)}
CPU = ext.EigenContext(device=torch.device("cpu"))


@pytest.mark.parametrize("mode", ["A", "N", "X", "S", "T", "C"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_drivers_match_jax(driver, dtype, mode):
    port, ref = DRIVERS[driver]
    a = sym(N, 60).astype(dtype)
    jw, jz, _ = ref(jnp.asarray(a), mode=mode, profile=True)
    w, z, info = port(t(a), mode=mode)
    jw = n_(jw)
    assert info.mode == mode and info.n == N and info.nvec == N
    assert info.flops == tsolver.flop_model(N, N, mode in "AXS")
    assert w.shape == (N,) and str(w.dtype) == f"torch.{jw.dtype}"
    scale = np.abs(jw).max()
    # modes S and C return the reduction's diagonal (see the module's note)
    tol = (D_TOL if mode in "SC" else W_TOL)[dtype] * np.abs(
        np.linalg.eigvalsh(a.astype(np.float64))).max()
    np.testing.assert_allclose(n_(w), jw, rtol=0, atol=tol)
    if mode == "N":
        assert z is None and jz is None
        return
    assert z.shape == (N, N) and z.dtype == t(a).dtype
    if mode == "C":
        np.testing.assert_array_equal(n_(z), np.eye(N))
    elif mode == "S":                 # Z = Q, the reduction's factor
        assert orthogonality_check(z).passed
        if dtype == np.float64:
            np.testing.assert_allclose(n_(z), n_(jz), rtol=0, atol=1e-10)
    elif mode == "T":                 # Z = eigenvectors of the reduced T
        assert orthogonality_check(z).passed
        if dtype == np.float64:
            assert_same_eigenspaces(z, jz, w, tol=1e-9, gap=1e-8 * scale)
    else:
        assert residual_check(t(a), z, w).passed
        assert orthogonality_check(z).passed
        if dtype == np.float64:
            assert_same_eigenspaces(z, jz, w, tol=1e-8, gap=1e-8 * scale)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_modes_agree_with_each_other(driver):
    """N's bisection and X's refinement land where A's D&C does; T and S
    compose to A; X's vectors are A's (only w is refined)."""
    port = DRIVERS[driver][0]
    a = t(sym(N, 61))
    wa, za, _ = port(a)
    scale = float(wa.abs().max())
    for mode in "NX":
        w, _, _ = port(a, mode=mode)
        assert float((w - wa).abs().max()) < 1e-12 * scale
    _, zx, _ = port(a, mode="X")
    assert torch.equal(zx, za)
    _, zt, _ = port(a, mode="T")
    _, zs, _ = port(a, mode="S")
    assert_same_eigenspaces(zs @ zt, za, wa, tol=1e-9, gap=1e-8 * scale)


@pytest.mark.parametrize("mode", ["A", "N", "X"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_nan_input_poisons_w(driver, mode):
    port, ref = DRIVERS[driver]
    a = sym(40, 62)
    a[3, 4] = a[4, 3] = np.nan
    w, _, _ = port(t(a), mode=mode)
    jw, _, _ = ref(jnp.asarray(a), mode=mode, profile=True)
    assert torch.isnan(w).all() and np.isnan(n_(jw)).all()


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_profile_names_the_drivers_stages(driver):
    port = DRIVERS[driver][0]
    red = "TRD-BLK" if driver == "eigen_s" else "PRD-BLK"
    a = t(sym(80, 63))
    w0, z0, _ = port(a)
    w, z, info = port(a, profile=True)
    assert list(info.stages) == [red, "D&C", "TRDBAK"]
    assert torch.equal(w, w0) and torch.equal(z, z0)
    _, _, info = port(a, mode="N", profile=True)
    assert list(info.stages) == [red, "BISECT"]
    assert info.stages["BISECT"]["flops"] == 0.0


def _reduced(a, band2):
    if band2:
        red = tb.band2_reduce(t(a), nb=16)
        return red.d, red.e1, red.e2
    red = tridiagonalize(t(a), nb=16)
    return red.d, red.e


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_mode_r_matches_jax_and_reads_back_its_files(driver, tmp_path):
    """Mode R on the reduction's own bands: a tuple and the files written
    from it give the same bits; the JAX driver on the same bands gives the
    same w; eigen_s takes (d, e) from a pentadiagonal's files too and
    ignores F.data, as the reference does."""
    from eigenexa_tpu_torch.utils.stageio import save_stage_data

    port, ref = DRIVERS[driver]
    bands = _reduced(sym(N, 64), driver == "eigen_sx")
    save_stage_data(tmp_path, *bands)
    w, z, info = port(None, mode="R", stage_data=bands)
    wf, zf, _ = port(None, mode="r", stage_data=str(tmp_path), ctx=CPU)
    assert info.mode == "R" and info.n == N and z.dtype == torch.float64
    assert torch.equal(w, wf) and torch.equal(z, zf)
    jw, jz, _ = ref(None, mode="R",
                    stage_data=tuple(jnp.asarray(n_(b)) for b in bands))
    np.testing.assert_allclose(n_(w), n_(jw), rtol=0,
                               atol=1e-11 * np.abs(n_(jw)).max())
    reduced = (tb.assemble_band2(*bands) if len(bands) == 3 else
               assemble_tridiag(*bands))
    assert residual_check(reduced, z, w).passed
    w8, z8, info = port(None, nvec=8, mode="R", stage_data=bands)
    assert z8.shape == (N, 8) and info.nvec == 8 and torch.equal(w8, w)
    if driver == "eigen_s":
        tri = _reduced(sym(N, 64), True)
        save_stage_data(tmp_path / "penta", *tri)
        wp, _, _ = port(None, mode="R", stage_data=str(tmp_path / "penta"),
                        ctx=CPU)
        wt, _, _ = port(None, mode="R", stage_data=tri[:2])
        assert torch.equal(wp, wt)
