"""The port's distributed layer (``eigenexa_tpu_torch/parallel``,
``solvers/dc_dist.py``) on the CPU over gloo.

One spawned world of four CPU ranks runs every case
(``_torch_dist_cases.world``) on the meshes (2,2), (1,4), (4,1), (1,2),
(1,3) (no power of two: the replicated D&C) and (1,1); the world runs in a
thread while this process computes the JAX package's results, and each
case is compared here.  Held against the JAX package's distributed
functions on ``build_mesh(jax.devices()[:4], …)`` of the same shape:
``solve_tridiag_dist`` (n = 128), ``distributed_eigen_s`` f64 on (2,2) and
(1,4), ``distributed_eigen_h`` c128 and ``distributed_eigen_gev`` f64 mode
A on (2,2), all at n = 64.  The rest against numpy, the JAX package's pure
pieces, or the port's single-device drivers (which the earlier parity tests
hold to the JAX package).

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as cases
from eigenexa_tpu.parallel import distributed as jdist
from eigenexa_tpu.parallel import layout as jlayout
from eigenexa_tpu.parallel import mesh as jmesh
from eigenexa_tpu.runtime import SolverConfig as JaxConfig
from eigenexa_tpu.solvers.dc_dist import solve_tridiag_dist as jax_tree
from eigenexa_tpu_torch import eigen_gev, eigen_init, eigen_s
from eigenexa_tpu_torch.parallel import layout, launch
from eigenexa_tpu_torch.parallel import mesh as pmesh
from eigenexa_tpu_torch.parallel.distributed import _dist_comm_stats
from eigenexa_tpu_torch.parallel.trd_dist import comm_model_v_bcast
from eigenexa_tpu_torch.runtime import SolverConfig

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
    """The JAX package's results, computed while the world runs."""
    cfg = JaxConfig(panel_forward=cases.NB_F, panel_backward=cases.NB_B)

    def jm(shape):
        return jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                                shape=shape)

    def solve(fn, a, shape, *more):
        w, z = fn(jnp.asarray(a), *more, jm(shape), config=cfg)
        return {"w": np.asarray(w), "z": np.asarray(z)}

    d, e = cases.tridiag(128, 7)
    mesh22 = jm((2, 2))
    w, s = jax.jit(lambda d, e: jax_tree(d, e, mesh22, 128, jnp.float64))(
        jnp.asarray(d), jnp.asarray(e))
    ga, gb = cases.gev_pair(N, 3)
    return {
        "tree": {"w": np.asarray(w), "z": np.asarray(s)[:128, :128]},
        "s_22": solve(jdist.distributed_eigen_s, cases.designed(N, 1),
                      (2, 2)),
        "s_14": solve(jdist.distributed_eigen_s, cases.designed(N, 1),
                      (1, 4)),
        "h_22": solve(jdist.distributed_eigen_h, cases.designed(N, 2, True),
                      (2, 2)),
        "gev_22": solve(jdist.distributed_eigen_gev, ga, (2, 2),
                        jnp.asarray(gb)),
    }


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


def _single(a, nvec=None, mode="A"):
    ctx = eigen_init("cpu", config=cases.config())
    w, z, _ = eigen_s(torch.tensor(a), nvec=nvec, mode=mode, ctx=ctx)
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
                                  "group4", "group2_masked"])
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
        assert np.array_equal(world[r]["collectives"][name], want[name])


def test_calibrate_overheads_positive_and_equal_on_every_rank(world):
    cal = [world[r]["collectives"]["calibrate"] for r in range(4)]
    assert all(np.array_equal(c, cal[0]) for c in cal)
    assert cal[0][0] > 0 and cal[0][1] > 0


# ---------------------------------------------------------------------------
# the stages and the drivers against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tree", "s_22", "s_14", "h_22", "gev_22"])
def test_matches_jax_on_the_same_mesh(world, jax_refs, case):
    for r in range(4):
        _close(world[r][case], jax_refs[case])


def test_tree_chunked_top_merges_match_unchunked(world):
    _close(world[0]["tree_chunked"], world[0]["tree"])


def test_comm_stats_match_jax_but_for_the_v_broadcasts(world):
    cfg = SolverConfig(panel_forward=cases.NB_F, panel_backward=cases.NB_B)
    jcfg = JaxConfig(panel_forward=cases.NB_F, panel_backward=cases.NB_B)
    jm = jmesh.build_mesh(jax.devices()[:4], shape=(2, 2))
    want = jdist._dist_comm_stats(N, N, "A", jcfg, jm, jnp.float64)
    want.merge(comm_model_v_bcast(N, cases.NB_B, 2, 2, 8))
    got = world[0]["info"]
    assert got["report"] == want.report()
    assert got["comm_time"] > 0 and got["elapsed"] > 0


def test_comm_stats_model_matches_jax_apart_from_v_at_other_shapes():
    """The port's model beside JAX's on meshes where N = n = nvec (the
    back-transform then sends the same bytes in both)."""
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
            assert got.report() == want.report(), (shape, mode)


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
