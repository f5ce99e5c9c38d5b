"""The rank side of ``tests/test_torch_dist.py`` (not collected: no test_
prefix; imports torch and numpy only, so that a spawned rank starts
quickly).

``world`` runs on each rank of one spawned gloo world of four CPU ranks.
It builds every mesh of the cases once, in the same order on every rank
(``build_mesh`` is collective over the world), then runs each case on the
ranks of its mesh and returns {case: result}; the test process compares.
Inputs are made from numpy seeds, the same arrays the test process hands
the JAX package and the single-device port.
"""

from __future__ import annotations

import numpy as np
import torch

N = 64         # the cases held against the JAX package
N_PAD = 48     # the padded cases (N = 48 is no multiple of 4·16 … on some
#                meshes) held against the single-device port
N_PAD_SX = 40  # eigen_sx's padded cases: every mesh pads 40 to 48
N_BAND = 128   # the band-2 tree alone, with leaves of LEAF_BAND
LEAF_BAND = 16
N_DRYRUN = 64
NB_F, NB_B = 16, 32
K_INDEPENDENT = 5


def config():
    from eigenexa_tpu_torch.runtime import SolverConfig

    return SolverConfig(panel_forward=NB_F, panel_backward=NB_B)


def designed(n: int, seed: int, complex_: bool = False) -> np.ndarray:
    """Q·diag(w)·Qᴴ with two clusters, w in [1, 2] and [5, 6] (the lower
    n//2 eigenvalues and the upper): the projector onto each cluster's
    eigenvectors is well conditioned, whatever the order inside it."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    if complex_:
        g = g + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(g)
    h = n // 2
    w = np.concatenate([np.linspace(1, 2, h), np.linspace(5, 6, n - h)])
    a = (q * w) @ q.conj().T
    return 0.5 * (a + a.conj().T)


def gev_pair(n: int, seed: int):
    """(A, B), B = L·Lᵀ positive definite with spectrum in [1, 2], and
    A = L·Q·diag(w)·Qᵀ·Lᵀ: the generalized eigenvalues are `designed`'s
    two clusters."""
    b = _spd(n, seed + 100)
    ell = np.linalg.cholesky(b)
    a = ell @ designed(n, seed) @ ell.T
    return 0.5 * (a + a.T), b


def _spd(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    b = (q * np.linspace(1, 2, n)) @ q.T
    return 0.5 * (b + b.T)


def tridiag(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def pentadiag(n: int, seed: int):
    """(d, e1, e2) with two clusters of eigenvalues: d near 0 in the upper
    half of the rows and near 10 in the lower, off-diagonals of 0.3."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n) + 10.0 * (np.arange(n) >= n // 2)
    return d, 0.3 * rng.standard_normal(n - 1), 0.3 * rng.standard_normal(
        n - 2)


def batch(k: int, n: int, seed: int) -> np.ndarray:
    return np.stack([designed(n, seed + i) for i in range(k)])


# every mesh of the cases: (name, shape, world ranks)
MESHES = (("22", (2, 2), None), ("14", (1, 4), None), ("41", (4, 1), None),
          ("12", (1, 2), [0, 1]), ("13", (1, 3), [0, 1, 2]),
          ("11", (1, 1), [0]), ("22R", (2, 2), None))


def _collectives(mesh):
    """Every collective on a 2×2 mesh; rank r's input is 10·flat + i."""
    from eigenexa_tpu_torch.parallel import collectives as c
    from eigenexa_tpu_torch.parallel import distributed as D

    v = 10.0 * mesh.flat + torch.arange(3, dtype=torch.float64)
    vc = v * (1 + 1j)
    out = {
        "psum_x": c.psum_x(v, mesh), "psum_y": c.psum_y(v, mesh),
        "psum_grid": c.psum_grid(v, mesh), "psum_c": c.psum_x(vc, mesh),
        "pmax_x": c.pmax(v, mesh, "x"), "pmax_y": c.pmax(v, mesh, "y"),
        "pmax_grid": c.pmax(v, mesh, c.GRID),
        "own_x": c.bcast_from_owner(v, mesh.ix == 1, mesh, "x"),
        "bcast_y": c.bcast(v, mesh, "y", root=1),
        "gather_x": c.all_gather(v, mesh, "x"),
        "gather_y": c.all_gather(v, mesh, "y", tiled=False),
        "gather_grid": c.all_gather(v, mesh, c.GRID),
        "datacast": c.datacast_block(v, mesh, "x", "y", 3),
        "datacast_and_sum": torch.cat(c.datacast_block_and_sum(
            v, 2 * v, mesh, "x", "y", 3)),
        "group2": c.grouped_allreduce(v, 2, mesh),
        "group4": c.grouped_allreduce(v, 4, mesh),
        "input": v,
    }
    groups, mesh.merge_groups = mesh.merge_groups, {}
    try:   # the masked form of the same group sum
        out["group2_masked"] = c.grouped_allreduce(v, 2, mesh)
    finally:
        mesh.merge_groups = groups
    # calibrate_overheads through the drivers' cache, which "info" reuses
    out["calibrate"] = np.array(D._mesh_overheads(mesh))
    return out


def _solve(drive, a, mesh, n, nvec=None, mode="A", dtype=None):
    from eigenexa_tpu_torch.parallel.distributed import gather_matrix

    a = torch.as_tensor(a if dtype is None else a.astype(dtype))
    nvec = n if nvec is None else nvec
    w, z = drive(a, mesh, nvec=nvec, mode=mode, config=config())
    return {"w": w, "z": None if z is None
            else gather_matrix(z, mesh, (n, nvec))}


def world(mesh):
    """Every case of the module on the 4-rank world `mesh` (2×2)."""
    from eigenexa_tpu_torch import eigen_get_id, eigen_get_procs, eigen_init
    from eigenexa_tpu_torch.entry import dryrun_rank
    from eigenexa_tpu_torch.parallel import distributed as D
    from eigenexa_tpu_torch.parallel.mesh import build_mesh
    from eigenexa_tpu_torch.solvers import dc_tree
    from eigenexa_tpu_torch.solvers.dc_band_dist import solve_band2_dist
    from eigenexa_tpu_torch.solvers.dc_dist import solve_tridiag_dist

    meshes = {name: build_mesh(shape, order="R" if name == "22R" else "C",
                               ranks=ranks, device=mesh.device)
              for name, shape, ranks in MESHES}
    out = {}

    def on(name, key, fn, *args, **kw):
        m = meshes[name]
        if m is not None:
            out[key] = fn(*args, m, **kw) if args else fn(m, **kw)

    for name, m in meshes.items():
        if m is not None:
            ctx = eigen_init("cpu", mesh=m)
            out[f"mesh_{name}"] = {"pos": (m.ix, m.iy), "flat": m.flat,
                                   "id": eigen_get_id(ctx),
                                   "procs": eigen_get_procs(ctx),
                                   "matdims": ctx.matdims(1000)}
    out["collectives"] = _collectives(meshes["22"])

    # the tree alone, n = 128 (JAX parity), then its chunked top merges
    d, e = tridiag(128, 7)

    def tree(m):
        w, s = solve_tridiag_dist(torch.tensor(d), torch.tensor(e), m, 128,
                                  128, torch.float64)
        return {"w": w, "z": D.gather_matrix(s, m, (128, 128))}

    out["tree"] = tree(meshes["22"])
    chunk = dc_tree._LEVEL_CHUNK_MIN, dc_tree._LEVEL_CHUNK_PANEL
    dc_tree._LEVEL_CHUNK_MIN, dc_tree._LEVEL_CHUNK_PANEL = 64, 16
    try:
        out["tree_chunked"] = tree(meshes["22"])
    finally:
        dc_tree._LEVEL_CHUNK_MIN, dc_tree._LEVEL_CHUNK_PANEL = chunk

    # the band-2 tree alone (JAX parity; with leaves of 16, phase 1 joins
    # inside each rank's rows), then with every join panel-chunked
    bands = [torch.tensor(x) for x in pentadiag(N_BAND, 8)]

    def band_tree(m, **chunk):
        w, s = solve_band2_dist(*bands, m, N_BAND, N_BAND, torch.float64,
                                leaf=LEAF_BAND, **chunk)
        return {"w": w, "z": D.gather_matrix(s, m, (N_BAND, N_BAND))}

    on("22", "band_tree", band_tree)
    on("22", "band_tree_chunked", band_tree, chunk_min=2 * LEAF_BAND,
       chunk_panel=16)

    a = designed(N, 1)
    s_ = D.distributed_eigen_s
    on("22", "s_22", _solve, s_, a, n=N)
    on("14", "s_14", _solve, s_, a, n=N)
    on("22", "h_22", _solve, D.distributed_eigen_h, designed(N, 2, True),
       n=N)
    ga, gb = gev_pair(N, 3)

    def gev(m, mode="A", b=gb, n=N):
        w, z = D.distributed_eigen_gev(torch.tensor(ga[:n, :n]),
                                       torch.tensor(b[:n, :n]), m,
                                       mode=mode, config=config())
        return {"w": w, "z": None if z is None
                else D.gather_matrix(z, m, (n, n))}

    on("22", "gev_22", gev)
    on("22", "gev_N", gev, mode="N", n=N_PAD)
    on("22", "gev_not_pd", gev, b=-gb, n=N_PAD)

    a48 = designed(N_PAD, 4)
    on("41", "s_41", _solve, s_, a48, n=N_PAD)
    on("12", "s_12_f32", _solve, s_, a48, n=N_PAD, dtype=np.float32)
    on("13", "s_13", _solve, s_, a48, n=N_PAD)
    on("11", "s_11", _solve, s_, a48, n=N_PAD)
    on("22R", "s_22R", _solve, s_, a48, n=N_PAD)
    for mode in "NXTSC":
        on("22", f"mode_{mode}", _solve, s_, a48, n=N_PAD, nvec=20,
           mode=mode)
    on("22", "a_22", _solve, s_, a48, n=N_PAD, nvec=20)
    on("22", "a_22_again", _solve, s_, a48, n=N_PAD, nvec=20)
    on("22", "nan", _solve, s_, np.where(np.eye(N_PAD) > 0, np.nan, a48),
       n=N_PAD)

    def independent(m):
        w, z = D.independent_solves(torch.tensor(batch(K_INDEPENDENT, N_PAD,
                                                       5)), m,
                                    config=config())
        return {"w": w, "z": z}

    on("22", "independent", independent)

    def info(m):
        _, _, inf = D.distributed_eigen_s(torch.tensor(a), m, config=config(),
                                          with_info=True)
        return {"report": inf.comm_stats.report(),
                "comm_time": inf.comm_time, "elapsed": inf.elapsed}

    on("22", "info", info)

    # distributed_eigen_sx: against the JAX package at N, against the
    # single-device eigen_sx at N_PAD_SX (padded to 48 on every mesh) and
    # in the modes
    sx = D.distributed_eigen_sx

    def sx_info(m):
        w, z, inf = sx(torch.tensor(a), m, config=config(), with_info=True)
        return {"w": w, "z": D.gather_matrix(z, m, (N, N)),
                "report": inf.comm_stats.report(),
                "comm_time": inf.comm_time, "elapsed": inf.elapsed}

    on("22", "sx_22", sx_info)
    on("14", "sx_14", _solve, sx, a, n=N)
    a40 = designed(N_PAD_SX, 6)
    on("22", "sx_pad_22", _solve, sx, a40, n=N_PAD_SX)
    on("41", "sx_pad_41", _solve, sx, a40, n=N_PAD_SX)
    on("12", "sx_pad_12_f32", _solve, sx, a40, n=N_PAD_SX, dtype=np.float32)
    on("13", "sx_pad_13", _solve, sx, a40, n=N_PAD_SX)
    for mode in "NXTSC":
        on("22", f"sx_mode_{mode}", _solve, sx, a48, n=N_PAD, nvec=20,
           mode=mode)
    on("22", "sx_again", _solve, sx, a40, n=N_PAD_SX)
    on("22", "sx_nan", _solve, sx, np.where(np.eye(N_PAD) > 0, np.nan, a48),
       n=N_PAD)
    on("22", "training_step", lambda m: dict(zip(
        ("w", "z", "resid"), D.training_step(m, 32, torch.float64))))
    on("22", "dryrun", dryrun_rank, n=N_DRYRUN)
    return out


def card_solve(mesh, n: int, driver: str = "s"):
    """Frank n f32 through ``distributed_eigen_s`` (`driver` "s") or
    ``distributed_eigen_sx`` ("sx") on the card: w, the checks on the
    gathered Z, and this rank's ``sub_matmul`` launches."""
    from eigenexa_tpu_torch.ops import kernels
    from eigenexa_tpu_torch.parallel import distributed as D
    from eigenexa_tpu_torch.parallel.distributed import gather_matrix
    from eigenexa_tpu_torch.testing import (frank, orthogonality_check,
                                            residual_check)

    a = frank(n, torch.float32, mesh.device)
    kernels.LAUNCHES["sub_matmul"] = 0
    w, z = getattr(D, f"distributed_eigen_{driver}")(a, mesh)
    launches = kernels.LAUNCHES["sub_matmul"]
    z = gather_matrix(z, mesh, (n, n))
    return {"w": w, "launches": launches,
            "residual": residual_check(a, z, w).value,
            "orthogonality": orthogonality_check(z).value}


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist

    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1), group=mesh.grid_group)


def sleep_long(mesh):
    import time

    time.sleep(600)
