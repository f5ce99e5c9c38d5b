"""The port's distributed layer (``eigenexa_tpu_torch/parallel``,
``solvers/dc_dist.py``, ``solvers/dc_band_dist.py``, ``entry.py``) on the
CPU over gloo.

One spawned world of four CPU ranks runs every case
(``_torch_dist_cases.world``) on the meshes (2,2), (1,4), (4,1), (1,2),
(1,3) (no power of two: the replicated D&C) and (1,1); the world runs in a
thread while this process computes the JAX package's results, and each
case is compared here.  Held against the JAX package's distributed
functions on ``build_mesh(jax.devices()[:4], …)`` of the same shape:
``solve_tridiag_dist`` (n = 128), ``solve_band2_dist`` (n = 128, leaves of
16), ``distributed_eigen_s`` and ``distributed_eigen_sx`` f64 on (2,2) and
(1,4), ``distributed_eigen_h`` c128 and ``distributed_eigen_gev`` f64 mode
A on (2,2), all at n = 64, and ``training_step`` on (2,2).  The rest
against numpy, the JAX package's pure pieces, or the port's single-device
drivers (which the earlier parity tests hold to the JAX package).

Tolerances:
* w within 1e-12·max(1, max|w|) in f64 and c128, 1e-5·max(1, max|w|) in
  f32 and c64 (the summation orders of the collectives and of the two
  packages' products differ);
* Z through the projector onto the eigenvectors of the lower cluster of
  the designed spectra (``_torch_dist_cases.designed``: two clusters, the
  gap 3 against a norm of 6), to the same bounds;
* modes S and C, whose outputs drift with the reduction's backward error,
  through their checks.

The spawn has a timeout of 120 s, so that a hung rank fails the module
instead of holding the suite.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as cases
from eigenexa_tpu.parallel import distributed as jdist
from eigenexa_tpu.parallel import layout as jlayout
from eigenexa_tpu.parallel import mesh as jmesh
from eigenexa_tpu.parallel.prd_dist import comm_model_prd as jax_prd_model
from eigenexa_tpu.parallel.trd_dist import comm_model_trbak as jax_trbak_model
from eigenexa_tpu.runtime import SolverConfig as JaxConfig
from eigenexa_tpu.solvers.dc_band_dist import solve_band2_dist as jax_band
from eigenexa_tpu.solvers.dc_dist import solve_tridiag_dist as jax_tree
from eigenexa_tpu_torch import eigen_gev, eigen_init, eigen_s, eigen_sx
from eigenexa_tpu_torch.entry import dryrun_multichip
from eigenexa_tpu_torch.parallel import layout, launch
from eigenexa_tpu_torch.parallel import mesh as pmesh
from eigenexa_tpu_torch.parallel.distributed import (_dist_comm_stats,
                                                     distributed_eigen_sx,
                                                     padded_size)
from eigenexa_tpu_torch.parallel.trd_dist import comm_model_v_bcast
from eigenexa_tpu_torch.runtime import SolverConfig
from eigenexa_tpu_torch.solvers.dc_band_dist import comm_model_dc_band
from eigenexa_tpu_torch.solvers.dc_dist import _tree_sizes

TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12,
       np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5}
SPAWN_TIMEOUT = 120
N, N_PAD = cases.N, cases.N_PAD


@pytest.fixture(scope="module")
def world_future():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch.spawn, cases.world, (2, 2), "gloo", "cpu",
                      timeout=SPAWN_TIMEOUT)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_refs(world_future):
    """The JAX package's results, computed while the world runs, three at a
    time (each is mostly one XLA compile)."""
    cfg = JaxConfig(panel_forward=cases.NB_F, panel_backward=cases.NB_B)

    def jm(shape):
        return jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                                shape=shape)

    def solve(fn, a, shape, *more):
        w, z = fn(jnp.asarray(a), *more, jm(shape), config=cfg)
        return {"w": np.asarray(w), "z": np.asarray(z)}

    def tree():
        w, s = jax.jit(lambda d, e: jax_tree(d, e, jm((2, 2)), 128,
                                             jnp.float64))(
            *map(jnp.asarray, cases.tridiag(128, 7)))
        return {"w": np.asarray(w), "z": np.asarray(s)[:128, :128]}

    def band_tree():
        nb = cases.N_BAND
        w, s = jax.jit(lambda *b: jax_band(*b, jm((2, 2)), nb, jnp.float64,
                                           leaf=cases.LEAF_BAND))(
            *map(jnp.asarray, cases.pentadiag(nb, 8)))
        return {"w": np.asarray(w), "z": np.asarray(s)[:nb, :nb]}

    def training_step():
        w, z, resid = jdist.training_step(jm((2, 2)), 32, jnp.float64)
        return {"w": np.asarray(w), "z": np.asarray(z), "resid": float(resid)}

    ga, gb = cases.gev_pair(N, 3)
    jobs = {
        "tree": tree, "band_tree": band_tree, "training_step": training_step,
        "gev_22": lambda: solve(jdist.distributed_eigen_gev, ga, (2, 2),
                                jnp.asarray(gb)),
        "h_22": lambda: solve(jdist.distributed_eigen_h,
                              cases.designed(N, 2, True), (2, 2)),
    }
    for name, fn in (("s", jdist.distributed_eigen_s),
                     ("sx", jdist.distributed_eigen_sx)):
        for shape in ((2, 2), (1, 4)):
            jobs[f"{name}_{shape[0]}{shape[1]}"] = functools.partial(
                solve, fn, cases.designed(N, 1), shape)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(fn) for name, fn in jobs.items()}
        return {name: fut.result() for name, fut in futures.items()}


@pytest.fixture(scope="module")
def world(world_future, jax_refs):
    return world_future.result(timeout=SPAWN_TIMEOUT)


def _tol(x, w):
    return TOL[np.asarray(x).dtype] * max(1.0, float(np.abs(w).max()))


def _projector(z, h):
    z = np.asarray(z)[:, :h]
    return z @ z.conj().T


def _close(got, want, h=None):
    """w and the lower-cluster projector of Z within the dtype's bound."""
    w, w0 = np.asarray(got["w"]), np.asarray(want["w"])
    tol = _tol(got["z"] if got.get("z") is not None else w, w0)
    assert w.shape == w0.shape
    assert np.abs(w - w0).max() <= tol, np.abs(w - w0).max()
    if got.get("z") is not None:
        h = h or w0.shape[0] // 2
        dz = np.abs(_projector(got["z"], h) - _projector(want["z"], h)).max()
        assert dz <= tol, dz


def _single(a, nvec=None, mode="A", drive=eigen_s):
    ctx = eigen_init("cpu", config=cases.config())
    w, z, _ = drive(torch.tensor(a), nvec=nvec, mode=mode, ctx=ctx)
    return {"w": w.numpy(), "z": None if z is None else z.numpy()}


# ---------------------------------------------------------------------------
# the mesh and the layout against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", range(1, 25))
def test_factor_grid_matches_jax(p):
    assert pmesh.factor_grid(p) == jmesh.factor_grid(p)


@pytest.mark.parametrize("order", ["C", "R"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2), (1, 4), (3, 2)])
def test_rank_placement_matches_jax(shape, order):
    p = shape[0] * shape[1]
    m = jmesh.build_mesh(jax.devices()[:p], shape=shape, order=order)
    pos = pmesh.grid_positions(p, shape, order)
    for r in range(p):
        ix, iy = pos[r]
        assert m.devices[ix, iy].id == r


@pytest.mark.parametrize("name,order", [("22", "C"), ("22R", "R")])
def test_ranks_take_their_grid_positions(world, name, order):
    pos = pmesh.grid_positions(4, (2, 2), order)
    for r in range(4):
        got = world[r][f"mesh_{name}"]
        assert tuple(got["pos"]) == pos[r]
        assert got["flat"] == pos[r][0] * 2 + pos[r][1]
        assert tuple(got["id"]) == (r, *pos[r])
        assert tuple(got["procs"]) == (4, 2, 2)
        assert tuple(got["matdims"]) == jlayout.padded_local_dims(1000, 2, 2)
    assert "mesh_12" not in world[2] and "mesh_11" not in world[1]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_cyclic_helpers_match_jax(p, b):
    g = np.arange(37)
    t = torch.arange(37)
    owner = np.asarray(jlayout.cyclic_owner(g, p, b))
    assert np.array_equal(layout.cyclic_owner(t, p, b).numpy(), owner)
    loc = np.asarray(jlayout.cyclic_g2l(g, p, b))
    assert np.array_equal(layout.cyclic_g2l(t, p, b).numpy(), loc)
    assert np.array_equal(
        layout.cyclic_l2g(torch.tensor(loc), torch.tensor(owner), p,
                          b).numpy(), g)
    for r in range(p):
        assert (layout.cyclic_local_count(37, r, p, b)
                == jlayout.cyclic_local_count(37, r, p, b))
        assert np.array_equal(layout.cyclic_indices(5, r, p, b).numpy(),
                              np.asarray(jlayout.cyclic_indices(5, r, p, b)))
    assert layout.cyclic_local_size(37, p, b) == jlayout.cyclic_local_size(
        37, p, b)
    assert layout.padded_local_dims(1000, p, 4, b) == \
        jlayout.padded_local_dims(1000, p, 4, b)


def test_int32_guard_matches_jax():
    layout.check_int32_overflow(10, 1 << 15, 1 << 15)
    for mod in (layout, jlayout):
        with pytest.raises(ValueError, match="int32"):
            mod.check_int32_overflow(10, 1 << 16, 1 << 15)


def test_backend_rule_raises_instead_of_switching():
    with pytest.raises(ValueError, match="gloo"):
        launch.spawn(cases.world, (1, 1), "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        launch.spawn(cases.world, (1, 1), "mpi", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            launch.spawn(cases.world, (1, 1), "gloo", "cuda")


def test_mesh_defaults_to_the_card_and_never_to_the_cpu(monkeypatch):
    """Without a card, a mesh built with no device raises (before any
    collective) instead of running on the CPU: the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: pmesh.build_mesh((1, 1)),
                  pmesh.single_device_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# ---------------------------------------------------------------------------
# the collectives against numpy
# ---------------------------------------------------------------------------

def _inputs(world):
    """(2, 2, 3): rank (ix, iy)'s input."""
    out = np.zeros((2, 2, 3))
    for r in range(4):
        ix, iy = world[r]["mesh_22"]["pos"]
        out[ix, iy] = world[r]["collectives"]["input"]
    return out


@pytest.mark.parametrize("name", ["psum_x", "psum_y", "psum_grid", "psum_c",
                                  "pmax_x", "pmax_y", "pmax_grid", "own_x",
                                  "bcast_y", "gather_x", "gather_y",
                                  "gather_grid", "datacast", "group2",
                                  "group4", "group2_masked",
                                  "datacast_and_sum"])
def test_collective_matches_numpy(world, name):
    v = _inputs(world)
    for r in range(4):
        ix, iy = world[r]["mesh_22"]["pos"]
        flat = ix * 2 + iy
        want = {
            "psum_x": v[:, iy].sum(0), "psum_y": v[ix].sum(0),
            "psum_grid": v.sum((0, 1)), "psum_c": v[:, iy].sum(0) * (1 + 1j),
            "pmax_x": v[:, iy].max(0), "pmax_y": v[ix].max(0),
            "pmax_grid": v.max((0, 1)), "own_x": v[1, iy],
            "bcast_y": v[ix, 1], "gather_x": v[:, iy].reshape(-1),
            "gather_y": v[ix], "gather_grid": v.reshape(-1),
            "datacast": v[:, iy].reshape(-1)[3 * iy:3 * iy + 3],
            "group2": v.reshape(4, 3)[flat // 2 * 2:flat // 2 * 2 + 2].sum(0),
            "group4": v.sum((0, 1)),
        }
        want["group2_masked"] = want["group2"]
        want["datacast_and_sum"] = np.concatenate(
            [want["datacast"], 2 * want["psum_x"]])
        assert np.array_equal(world[r]["collectives"][name], want[name])


def test_calibrate_overheads_positive_and_equal_on_every_rank(world):
    cal = [world[r]["collectives"]["calibrate"] for r in range(4)]
    assert all(np.array_equal(c, cal[0]) for c in cal)
    assert cal[0][0] > 0 and cal[0][1] > 0


# ---------------------------------------------------------------------------
# the stages and the drivers against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tree", "s_22", "s_14", "h_22", "gev_22",
                                  "band_tree", "sx_22", "sx_14"])
def test_matches_jax_on_the_same_mesh(world, jax_refs, case):
    for r in range(4):
        _close(world[r][case], jax_refs[case])


def test_tree_chunked_top_merges_match_unchunked(world):
    _close(world[0]["tree_chunked"], world[0]["tree"])


def test_band_tree_chunked_merges_match_unchunked(world):
    """Every join of the band-2 tree in column panels (phase 1's inside a
    rank's rows and phase 2's across ranks) against the whole
    transforms."""
    for r in range(4):
        _close(world[r]["band_tree_chunked"], world[r]["band_tree"])


def test_training_step_matches_jax(world, jax_refs):
    want = jax_refs["training_step"]
    assert want["resid"] < 1e-13
    for r in range(4):
        got = world[r]["training_step"]
        assert float(got["resid"]) < 1e-13
        _close(got, want)


def _trd_differences(st, n_pad: int, nb: int, item: int = 8):
    """What the port's TRD sends otherwise than the JAX model counts: each
    column's Uᴴv and Wᴴv (2·nb values a rank) ride in v's datacast, and
    the next column's rows of U and W with its v and q entries (2·nb + 2
    values, all but a panel's last column) in the vᴴq sum, where the JAX
    model counts a sum and a broadcast: two collectives less a column."""
    cols, panels = n_pad, n_pad // nb
    st.record("bcast", -cols * 2 * nb * item, -cols)
    st.record("reduce", (panels * (nb - 1) * (2 * nb + 2) - cols * 2 * nb)
              * item, -cols)
    st.record("redist", cols * 2 * nb * item, 0)
    return st


def _prd_differences(st, n_pad: int, nb: int, item: int = 8):
    """What the port's band-2 reduction sends otherwise than the JAX
    package's model of it (prd_dist.py:183-205) counts: a pair's sums are
    6 collectives with 15 + 2·m_x values where the JAX model counts 8 with
    10 + 2·m_x + 4·nb (the port merges CholeskyQR2's second round with the
    pivot entries, counts the two norms' gathers, 3 values each, sends
    Uᵀ·V, Wᵀ·V and v0·v1, the 7th scalar the JAX model leaves out, in V's
    datacast: 4·nb + 1 values more there); the next pair's rows of U, W and
    P (2·(2·nb + 2) values, all but a panel's last pair) ride in the sum of
    Vᵀ·P where the JAX model broadcasts the U/W rows; and the band is one
    sum over the grid where the JAX package makes three."""
    pairs, panels = n_pad // 2, n_pad // nb
    st.record("bcast", -pairs * 4 * nb * item, -pairs)
    st.record("reduce", (pairs * (5 - 4 * nb)
                         + panels * (nb // 2 - 1) * 2 * (2 * nb + 2)) * item,
              -2 * pairs - 2)
    st.record("redist", pairs * (4 * nb + 1) * item, 0)
    return st


def test_comm_stats_match_jax_but_for_the_v_broadcasts(world):
    """The JAX package's model with the port's V broadcasts and its TRD's
    merged sums (``_trd_differences``)."""
    cfg = SolverConfig(panel_forward=cases.NB_F, panel_backward=cases.NB_B)
    jcfg = JaxConfig(panel_forward=cases.NB_F, panel_backward=cases.NB_B)
    jm = jmesh.build_mesh(jax.devices()[:4], shape=(2, 2))
    want = jdist._dist_comm_stats(N, N, "A", jcfg, jm, jnp.float64)
    want.merge(comm_model_v_bcast(N, cases.NB_B, 2, 2, 8))
    _trd_differences(want, N, cfg.panel_forward)
    got = world[0]["info"]
    assert got["report"] == want.report()
    assert got["comm_time"] > 0 and got["elapsed"] > 0


def test_comm_stats_model_matches_jax_apart_from_v_at_other_shapes():
    """The port's model beside JAX's on meshes where N = n = nvec (the
    back-transform then sends the same bytes in both), with the TRD's
    merged sums."""
    for shape in [(1, 4), (4, 1), (2, 4)]:
        cfg = SolverConfig(panel_forward=16, panel_backward=32)
        jm = jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                              shape=shape)

        class M:
            px, py = shape
        M.shape = shape
        for mode in "ANS":
            got = _dist_comm_stats(64, 64, mode, cfg, M, torch.float64)
            want = jdist._dist_comm_stats(
                64, 64, mode, JaxConfig(panel_forward=16, panel_backward=32),
                jm, jnp.float64)
            if mode != "N":
                want.merge(comm_model_v_bcast(64, 32, *shape, 8))
            _trd_differences(want, 64, 16)
            assert got.report() == want.report(), (shape, mode)


def test_sx_comm_stats_match_jax_apart_from_the_named_differences(world):
    """distributed_eigen_sx's COMM_STAT against the JAX package's model of
    it (distributed.py:369-374: comm_model_prd + comm_model_trbak), apart
    from what the port's reduction sends otherwise (``_prd_differences``),
    the V broadcasts, and the band tree's group sums, which the JAX model
    leaves out."""
    item = 8
    want = jax_prd_model(N, cases.NB_F, 2, 2, item)
    want.merge(jax_trbak_model(N, N // 2, cases.NB_B, item))
    _prd_differences(want, N, cases.NB_F)
    want.merge(comm_model_v_bcast(N, cases.NB_B, 2, 2, item))
    want.merge(comm_model_dc_band(_tree_sizes(N, 4, 32)[0], 4, item))
    got = world[0]["sx_22"]
    assert got["report"] == want.report()
    assert got["comm_time"] > 0 and got["elapsed"] > 0


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (2, 4), (1, 3)])
def test_sx_comm_model_at_other_shapes(shape):
    """Modes N and S count the reduction alone and with the back-transform;
    T counts the tree; the padded N is band 2's."""
    cfg = SolverConfig(panel_forward=16, panel_backward=32)

    class M:
        px, py = shape
    M.shape = shape
    big = padded_size(40, *shape, 16, band=2)
    reduction = _prd_differences(jax_prd_model(big, 16, *shape, 8), big, 16)
    assert _dist_comm_stats(40, 40, "N", cfg, M, torch.float64,
                            band=2).report() == reduction.report()
    p = shape[0] * shape[1]
    tree = comm_model_dc_band(
        _tree_sizes(40, p, 32)[0] if p & (p - 1) == 0 else 40, p, 8)
    want = _dist_comm_stats(40, 40, "N", cfg, M, torch.float64, band=2)
    assert _dist_comm_stats(40, 40, "T", cfg, M, torch.float64,
                            band=2).report() == want.merge(tree).report()


@pytest.mark.parametrize("n", [1, 40, 47, 64, 100])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 3), (4, 1), (2, 3)])
@pytest.mark.parametrize("nb", [16, 15])
def test_band2_padding_keeps_pairs_inside_a_block(n, shape, nb):
    """The least N ≥ n whose blocks N/px and N/py are even and that the
    even panel width divides (JAX distributed.py:349-351)."""
    px, py = shape
    big = padded_size(n, px, py, nb, band=2)
    nb2 = nb + nb % 2

    def fits(m):
        return m % nb2 == 0 and (m // px) % 2 == 0 and m % px == 0 \
            and (m // py) % 2 == 0 and m % py == 0

    assert big >= n and fits(big)
    assert not any(fits(m) for m in range(n, big))


def test_sx_refuses_complex_input_and_dryrun_keeps_the_backend_rule():
    with pytest.raises(TypeError, match="distributed_eigen_h"):
        distributed_eigen_sx(np.eye(4, dtype=np.complex128), None)
    with pytest.raises(ValueError, match="gloo"):
        dryrun_multichip(4, "nccl", "cpu")


# ---------------------------------------------------------------------------
# against the single-device port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["s_41", "s_12_f32", "s_13", "s_11",
                                  "s_22R"])
def test_padded_meshes_match_single_device(world, case):
    a = cases.designed(N_PAD, 4)
    dtype = np.float32 if case.endswith("f32") else np.float64
    want = _single(a.astype(dtype))
    ranks = {"s_12_f32": 2, "s_13": 3, "s_11": 1}.get(case, 4)
    for r in range(ranks):
        got = world[r][case]
        assert got["z"].dtype == dtype
        _close(got, want)


@pytest.mark.parametrize("mode", ["N", "X", "T"])
def test_modes_match_single_device(world, mode):
    a = cases.designed(N_PAD, 4)
    want = _single(a, nvec=20, mode=mode)
    got = world[0][f"mode_{mode}"]
    if mode == "N":
        assert got["z"] is None
    _close(got, want, h=20)


def test_mode_s_checks(world):
    """Z = Q: orthonormal columns, and diag(Zᵀ·A·Z) is T's diagonal, w."""
    a = cases.designed(N_PAD, 4)
    got = world[0]["mode_S"]
    z, w = got["z"], got["w"]
    assert z.shape == (N_PAD, 20)
    tol = _tol(z, w)
    assert np.abs(z.T @ z - np.eye(20)).max() <= 100 * tol
    assert np.abs(np.diag(z.T @ a @ z) - w[:20]).max() <= 100 * tol


def test_mode_c_checks(world):
    """Z = I[:, :nvec]; w = T's diagonal, whose sum is trace(A)."""
    a = cases.designed(N_PAD, 4)
    got = world[0]["mode_C"]
    assert np.array_equal(got["z"], np.eye(N_PAD, 20))
    assert abs(got["w"].sum() - np.trace(a)) <= 100 * _tol(got["w"],
                                                            got["w"])


def test_rerun_is_bitwise_equal(world):
    for r in range(4):
        one, two = world[r]["a_22"], world[r]["a_22_again"]
        assert np.array_equal(one["w"], two["w"])
        assert np.array_equal(one["z"], two["z"])


def test_nan_input_poisons(world):
    assert np.isnan(world[0]["nan"]["w"]).all()


@pytest.mark.parametrize("case", ["sx_pad_22", "sx_pad_41", "sx_pad_12_f32",
                                  "sx_pad_13"])
def test_sx_padded_meshes_match_single_device(world, case):
    a = cases.designed(cases.N_PAD_SX, 6)
    dtype = np.float32 if case.endswith("f32") else np.float64
    want = _single(a.astype(dtype), drive=eigen_sx)
    ranks = {"sx_pad_12_f32": 2, "sx_pad_13": 3}.get(case, 4)
    for r in range(ranks):
        got = world[r][case]
        assert got["z"].dtype == dtype
        _close(got, want)


@pytest.mark.parametrize("mode", ["N", "X", "T"])
def test_sx_modes_match_single_device(world, mode):
    a = cases.designed(N_PAD, 4)
    want = _single(a, nvec=20, mode=mode, drive=eigen_sx)
    got = world[0][f"sx_mode_{mode}"]
    if mode == "N":
        assert got["z"] is None
    _close(got, want, h=20)


def test_sx_modes_s_and_c_checks(world):
    """Mode S: Z = Q, orthonormal, diag(Zᵀ·A·Z) the pentadiagonal's
    diagonal w; mode C: Z = I[:, :nvec], and w sums to trace(A)."""
    a = cases.designed(N_PAD, 4)
    z, w = world[0]["sx_mode_S"]["z"], world[0]["sx_mode_S"]["w"]
    tol = _tol(z, w)
    assert z.shape == (N_PAD, 20)
    assert np.abs(z.T @ z - np.eye(20)).max() <= 100 * tol
    assert np.abs(np.diag(z.T @ a @ z) - w[:20]).max() <= 100 * tol
    got = world[0]["sx_mode_C"]
    assert np.array_equal(got["z"], np.eye(N_PAD, 20))
    assert np.array_equal(got["w"], w)
    assert abs(w.sum() - np.trace(a)) <= 100 * tol


def test_sx_rerun_is_bitwise_equal_and_nan_poisons(world):
    for r in range(4):
        one, two = world[r]["sx_pad_22"], world[r]["sx_again"]
        assert np.array_equal(one["w"], two["w"])
        assert np.array_equal(one["z"], two["z"])
        assert np.isnan(world[r]["sx_nan"]["w"]).all()
        assert np.isnan(world[r]["sx_nan"]["z"]).all()


def test_dryrun_rank_passes_every_leg(world):
    """entry.dryrun_rank at n = 64 f64 on (2,2): the four drivers' checks,
    the same values on every rank."""
    legs = world[0]["dryrun"]
    assert set(legs) == {"eigen_s", "eigen_sx", "eigen_gev", "eigen_h"}
    for leg, checks in legs.items():
        assert checks["w"] < 1.5e-8, leg
        assert max(v for k, v in checks.items() if k != "w") < 8, leg
    assert all(world[r]["dryrun"] == legs for r in range(4))


def test_gev_mode_n_matches_single_device(world):
    ga, gb = cases.gev_pair(N, 3)
    ctx = eigen_init("cpu", config=cases.config())
    w0, _, _ = eigen_gev(torch.tensor(ga[:N_PAD, :N_PAD]),
                         torch.tensor(gb[:N_PAD, :N_PAD]), mode="N",
                         ctx=ctx)
    got = world[0]["gev_N"]
    assert got["z"] is None
    _close(got, {"w": w0.numpy()})


def test_gev_not_positive_definite_poisons(world):
    got = world[0]["gev_not_pd"]
    assert np.isnan(got["w"]).all() and np.isnan(got["z"]).all()


def test_independent_solves_match_single_device(world):
    batch = cases.batch(cases.K_INDEPENDENT, N_PAD, 5)
    for r in range(4):
        got = world[r]["independent"]
        assert got["w"].shape == (cases.K_INDEPENDENT, N_PAD)
        for i in range(cases.K_INDEPENDENT):
            _close({"w": got["w"][i], "z": got["z"][i]}, _single(batch[i]))


def test_a_rank_that_raises_fails_the_spawn_at_once():
    """Its traceback reaches the caller, and the rank stuck in a collective
    with it is killed instead of waiting out the timeout."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(cases.fail_on_rank_1, (1, 2), "gloo", "cpu",
                     timeout=SPAWN_TIMEOUT)
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT / 2


def test_ranks_that_hang_time_out():
    with pytest.raises(TimeoutError, match="did not finish in 5"):
        launch.spawn(cases.sleep_long, (1, 2), "gloo", "cpu", timeout=5)
