"""Distributed drivers (counterpart of
``eigenexa_tpu/parallel/distributed.py``; reference: src/eigen_s.F:30,
src/eigen_sx.F:30, src/eigen_h.F:28 and src/KMATH_EIGEN_GEV_1.F:40-115 on
the 2D process grid of src/eigen_libs0.F:477).

scale → TRD (``trd_dist.trd_panel_shard``) or, for ``distributed_eigen_sx``,
PRD (``prd_dist.prd_panel_shard``) → D&C (``dc_dist.solve_tridiag_dist``,
``dc_band_dist.solve_band2_dist``) or bisection → TRBAK
(``trd_dist.trbak_shard``), each stage a function that every rank of the
mesh runs on its own blocks, with the reference's communication pattern
written out through ``parallel/collectives.py``.

The contract.  Every rank of the mesh calls a driver with the same
arguments, the global matrix among them (a tensor on any device or a numpy
array), and the driver takes this rank's block of it (``shard_matrix``, the
counterpart of the JAX package's ``shard_matrix``).  The matrix is
zero-padded to N = ``padded_size(n, px, py, nb, band)`` and block-sharded: rank
(ix, iy) holds rows [ix·N/px, (ix+1)·N/px) and columns [iy·N/py,
(iy+1)·N/py).  Every rank gets w back, the same everywhere, with its own
block of Z: rows [ix·N/px, (ix+1)·N/px) and columns [iy·c, (iy+1)·c), c =
⌈nvec/py⌉, zero outside the n × nvec matrix.  ``gather_matrix`` assembles
Z on every rank.  f32, f64, c64 and c128 run on the card (f32 and f64 in
``distributed_eigen_sx``); a CUDA block launches ``sub_matmul`` (the
trailing and WY updates) and, in modes N and X, ``sturm_bisect``, or
raises.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from eigenexa_tpu_torch.ops import sturm
from eigenexa_tpu_torch.parallel.collectives import (GRID, CommStats,
                                                     all_gather,
                                                     calibrate_overheads,
                                                     pmax)
from eigenexa_tpu_torch.parallel.prd_dist import (comm_model_prd,
                                                  prd_panel_shard)
from eigenexa_tpu_torch.parallel.trd_dist import (comm_model_trbak,
                                                  comm_model_trd,
                                                  comm_model_v_bcast,
                                                  trbak_shard,
                                                  trd_panel_shard)
from eigenexa_tpu_torch.runtime import EigenContext, SolverConfig, \
    apply_precision
from eigenexa_tpu_torch.solvers.dc_band_dist import (comm_model_dc_band,
                                                     solve_band2_dist)
from eigenexa_tpu_torch.solvers.dc_dist import (LEAF, _is_pow2, _tree_sizes,
                                                comm_model_dc,
                                                solve_tridiag_dist)
from eigenexa_tpu_torch.solvers.gev import gev_flop_model
from eigenexa_tpu_torch.solvers.solver import (SolveInfo, eigen_s,
                                               flop_model, scaling_factor)
from eigenexa_tpu_torch.testing.matgen import frank
from eigenexa_tpu_torch.utils.sync import device_sync

MODES = ("A", "N", "X", "S", "T", "C")


def panel_width(nb: int, band: int = 1) -> int:
    """The reduction's panel width: nb, rounded up to even for band 2
    (whole pairs of columns)."""
    return nb + nb % 2 if band == 2 else nb


def padded_size(n: int, px: int, py: int, nb: int, band: int = 1) -> int:
    """Smallest N ≥ n divisible by the panel width and both mesh axes (the
    eigen_get_matdims analogue of the block layout,
    src/eigen_libs0.F:1254).  For band 2 both block sizes N/px and N/py are
    even as well, so that a pair of columns never straddles a block (JAX
    distributed.py:349-351)."""
    m = math.lcm(band * px, band * py, panel_width(nb, band))
    return -(-n // m) * m


def _local(a, dtype=None) -> torch.Tensor:
    """The global matrix as a tensor (not copied where it already is
    one)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t if dtype is None else t.to(dtype)


def shard_matrix(a, mesh, big_n: int) -> torch.Tensor:
    """This rank's (N/px, N/py) block of the global matrix `a` zero-padded
    to N = big_n, on the mesh's device."""
    a = _local(a)
    n = a.shape[0]
    m_x, m_y = big_n // mesh.px, big_n // mesh.py
    r0, c0 = mesh.ix * m_x, mesh.iy * m_y
    out = torch.zeros((m_x, m_y), dtype=a.dtype, device=mesh.device)
    r1, c1 = min(r0 + m_x, n), min(c0 + m_y, n)
    if r0 < r1 and c0 < c1:
        out[:r1 - r0, :c1 - c0] = a[r0:r1, c0:c1]
    return out


def gather_matrix(z_loc, mesh, shape) -> torch.Tensor:
    """The whole (rows, cols) matrix `shape` from the ranks' blocks of the
    drivers' Z layout, on every rank (one all_gather over the grid)."""
    m_x, c = z_loc.shape
    blocks = all_gather(z_loc, mesh, GRID, tiled=False)
    full = blocks.reshape(mesh.px, mesh.py, m_x, c).permute(0, 2, 1, 3)
    return full.reshape(mesh.px * m_x, mesh.py * c)[:shape[0], :shape[1]]


def _eye_block(mesh, m_x: int, nv_y: int, n: int, nvec: int, dtype):
    """This rank's block of I[:n, :nvec] in the Z layout (eigen_identity,
    built on each rank)."""
    dev = mesh.device
    g_r = mesh.ix * m_x + torch.arange(m_x, device=dev)
    g_c = mesh.iy * nv_y + torch.arange(nv_y, device=dev)
    keep = ((g_r[:, None] == g_c[None, :]) & (g_r[:, None] < n)
            & (g_c[None, :] < nvec))
    return keep.to(dtype)


def _dist_solve(a_blk, n: int, nvec: int, mode: str, nb_f: int, nb_b: int,
                mesh, band: int = 1):
    """The distributed solve of one rank's padded block `a_blk` (consumed:
    scaled and reduced in place), modes as at distributed.py:99-153 (band
    1) and :254-322 (band 2).  Returns (w, this rank's Z block or None)."""
    dtype = a_blk.dtype
    rdtype = a_blk.real.dtype
    px, py = mesh.shape
    m_x = a_blk.shape[0]
    big_n = m_x * px
    # scaling: max |A| over the grid; a non-finite entry poisons sigma
    loc = a_blk.abs().amax()
    loc = torch.where(torch.isfinite(loc), loc, torch.full_like(loc,
                                                                 math.inf))
    sigma = scaling_factor(pmax(loc, mesh, GRID))
    a_blk.mul_(sigma)
    if band == 1:
        d_f, e_f, tau, v_loc = trd_panel_shard(a_blk, nb_f, mesh)
        offd = (e_f[:n - 1],)
        bisect, refine = sturm.eigvals_bisect, sturm.refine_eigenvalues
        solve = solve_tridiag_dist
    else:
        d_f, e1_f, e2_f, tau, v_loc = prd_panel_shard(a_blk, nb_f, mesh)
        offd = (e1_f[:n - 1], e2_f[:max(n - 2, 0)])
        bisect = sturm.eigvals_bisect_band2
        refine = sturm.refine_eigenvalues_band2
        solve = solve_band2_dist
    del a_blk
    d = d_f[:n]
    if mode == "N":
        return bisect(d, *offd) / sigma, None
    nv_y = -(-nvec // py)
    if mode in ("A", "X", "T"):
        w, z = solve(d, *offd, mesh, big_n, nvec, rdtype)
        if mode == "X":
            w = refine(d, *offd, w)
        w = w / sigma
        z = z.to(dtype)   # the real eigenvectors of T (convert_DtoZ)
        if mode == "T":
            return w, z
    else:
        w = d / sigma
        z = _eye_block(mesh, m_x, nv_y, n, nvec, dtype)
        if mode == "C":
            return w, z
    return w, trbak_shard(z, v_loc, tau, nb_b, mesh)


_OVERHEAD_CACHE: dict = {}


def _mesh_overheads(mesh):
    """The mesh's calibrated (latency, per-byte) collective costs, measured
    once a process (the eigen_init-time sampling of the reference,
    src/eigen_libs0.F:774-849); (0, 0) on one rank, where the drivers make
    no collective.  Every rank of the mesh calls it."""
    if mesh.size == 1:
        return 0.0, 0.0
    key = (mesh.shape, mesh.ranks, mesh.backend, str(mesh.device))
    if key not in _OVERHEAD_CACHE:
        _OVERHEAD_CACHE[key] = calibrate_overheads(mesh)
    return _OVERHEAD_CACHE[key]


def _dist_comm_stats(n: int, nvec: int, mode: str, cfg: SolverConfig,
                     mesh, dtype, band: int = 1) -> CommStats:
    """The COMM_STAT table of one distributed solve, from the stage models
    (JAX ``_dist_comm_stats``, distributed.py:169, and the model of
    ``distributed_eigen_sx``, :369-374), with the port's V broadcasts and
    its back-transform over ⌈nvec/py⌉ columns a rank.  Band 1 counts the
    D&C in the JAX package's modes A, X and S; band 2 where the band tree
    runs, modes A, X and T (the JAX package's band-2 model leaves it
    out)."""
    px, py = mesh.shape
    p = px * py
    nb_f = panel_width(cfg.panel_forward, band)
    big_n = padded_size(n, px, py, nb_f, band)
    item = dtype.itemsize
    n_pad = _tree_sizes(n, p, LEAF)[0] if _is_pow2(p) else n
    st = CommStats()
    if band == 1:
        st.merge(comm_model_trd(big_n, nb_f, px, py, item))
        if mode in ("A", "X", "S"):
            st.merge(comm_model_dc(n_pad, p, 8, item))
    else:
        st.merge(comm_model_prd(big_n, nb_f, px, py, item))
        if mode in ("A", "X", "T"):
            st.merge(comm_model_dc_band(n_pad, p, item))
    if mode in ("A", "X", "S"):
        st.merge(comm_model_trbak(big_n, -(-nvec // py), cfg.panel_backward,
                                  item))
        st.merge(comm_model_v_bcast(big_n, cfg.panel_backward, px, py,
                                    item))
    return st


def _drive(a, mesh, nvec, mode: str, config, with_info: bool, flops_of,
           dtype=None, band: int = 1):
    """What distributed_eigen_s, _sx and _h share: the mode, the block, the
    clock and the telemetry."""
    cfg = config or SolverConfig()
    mode = mode.upper()
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the distributed drivers "
                         f"take {MODES}")
    apply_precision(cfg)
    n = a.shape[0]
    nvec = n if nvec is None else min(nvec, n)
    nb_f = panel_width(cfg.panel_forward, band)
    big_n = padded_size(n, mesh.px, mesh.py, nb_f, band)
    if with_info:
        _mesh_overheads(mesh)   # calibrate outside the timed window
    t0 = time.perf_counter()
    a_blk = shard_matrix(_local(a, dtype), mesh, big_n)
    w, z = _dist_solve(a_blk, n, nvec, mode, nb_f, cfg.panel_backward,
                       mesh, band)
    if not with_info:
        return w, z
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    stats = _dist_comm_stats(n, nvec, mode, cfg, mesh, a_blk.dtype, band)
    info = SolveInfo(flops=flops_of(n, nvec, mode in ("A", "X", "S")),
                     elapsed=elapsed,
                     comm_time=stats.seconds(*_mesh_overheads(mesh)),
                     n=n, nvec=nvec, mode=mode, comm_stats=stats)
    return w, z, info


def distributed_eigen_s(a, mesh, nvec: Optional[int] = None,
                        mode: str = "A",
                        config: Optional[SolverConfig] = None,
                        with_info: bool = False):
    """eigen_s over the mesh (reference: src/eigen_s.F:30 on the 2D
    grid).  Returns (w, this rank's Z block), or (w, Z block, SolveInfo)
    with_info: elapsed, model flops, the COMM_STAT table and its calibrated
    time (the a(1,1)/a(2,1)/a(3,1) telemetry, src/eigen_s.F:284-295).
    Modes A/N/X/S/T/C as ``eigen_s``'s; w is float64 (T's diagonal in
    a's dtype in modes S and C), Z None in mode N."""
    return _drive(a, mesh, nvec, mode, config, with_info, flop_model)


def distributed_eigen_sx(a, mesh, nvec: Optional[int] = None,
                         mode: str = "A",
                         config: Optional[SolverConfig] = None,
                         with_info: bool = False):
    """eigen_sx over the mesh (reference: src/eigen_sx.F:30 on the 2D
    grid; JAX ``distributed_eigen_sx``, distributed.py:325): the band-2
    reduction by reflector pairs (``prd_dist``), the distributed band-2
    D&C (``dc_band_dist``) or, in modes N and X, band-2 Sturm bisection,
    and the same back-transform as ``distributed_eigen_s``.  Arguments,
    modes and returns as ``distributed_eigen_s``'s; `a` real (f32 or f64),
    padded as ``padded_size(…, band=2)`` says."""
    t = _local(a)
    if t.is_complex():
        raise TypeError("distributed_eigen_sx takes a real symmetric "
                        "matrix; a Hermitian one takes distributed_eigen_h")
    return _drive(t, mesh, nvec, mode, config, with_info, flop_model,
                  band=2)


def distributed_eigen_h(a, mesh, nvec: Optional[int] = None,
                        mode: str = "A",
                        config: Optional[SolverConfig] = None,
                        with_info: bool = False):
    """Hermitian eigensolver over the mesh (reference: src/eigen_h.F:28;
    complex comm twins src/comm_h.F): the pipeline of
    ``distributed_eigen_s`` on complex blocks; the reduction ends in a real
    tridiagonal, the D&C is real and its vectors are cast to complex.  A
    real `a` is cast to c64, or to c128 from f64.  The JAX package's
    real-pair embedding (distributed.py:421-440) is not ported (ROADMAP
    A13).  SolveInfo.flops is 4× the real model."""
    t = _local(a)
    dtype = (t.dtype if t.is_complex() else
             torch.complex128 if t.dtype == torch.float64
             else torch.complex64)
    return _drive(t, mesh, nvec, mode, config, with_info,
                  lambda *args: 4.0 * flop_model(*args), dtype=dtype)


def _gev_back(f, z2, mesh, n: int):
    """Z = F·Z′ on the Z layout (the back-multiply pdgemm of
    KMATH_EIGEN_GEV_1.F:115): Z′'s columns of this rank gathered along 'x',
    times this rank's rows of F."""
    m_x = z2.shape[0]
    cols = all_gather(z2, mesh, "x")[:n]
    r0 = mesh.ix * m_x
    r1 = min(r0 + m_x, n)
    f_rows = torch.zeros((m_x, n), dtype=f.dtype, device=f.device)
    if r0 < r1:
        f_rows[:r1 - r0] = f[r0:r1]
    return f_rows @ cols


def distributed_eigen_gev(a, b, mesh, nvec: Optional[int] = None,
                          mode: str = "A",
                          config: Optional[SolverConfig] = None,
                          with_info: bool = False):
    """A·x = λ·B·x over the mesh, B symmetric positive definite
    (reference: KMATH_EIGEN_GEV, src/KMATH_EIGEN_GEV_1.F:40-115):
    distributed_eigen_s(B) → F = V_B·D_B^{-1/2} → A′ = Fᵀ·A·F →
    distributed_eigen_s(A′) → Z = F·Z′.  Modes A and N.

    The congruence is replicated: every rank holds A (the contract) and
    gathers F whole (one all_gather over the grid), and computes A′ with
    two ``torch.matmul``s.  The back-multiply is distributed: this rank's
    rows of F times its columns of Z′ gathered along 'x'.  A B that is not
    positive definite poisons w and Z with NaN (the reference aborts,
    KMATH_EIGEN_GEV_1.F:47).  Returns (w, Z block (B-orthonormal Z) or
    None in mode N), with a SolveInfo when with_info."""
    cfg = config or SolverConfig()
    mode = mode.upper()
    if mode not in ("A", "N"):
        raise ValueError(f"distributed_eigen_gev supports modes 'A' and "
                         f"'N'; got {mode!r}")
    a = _local(a)
    n = a.shape[0]
    nvec = n if nvec is None else min(nvec, n)
    if with_info:
        _mesh_overheads(mesh)
    t0 = time.perf_counter()
    wb, vb = distributed_eigen_s(b, mesh, config=cfg)
    f = gather_matrix(vb, mesh, (n, n))
    del vb
    pd_ok = wb[0] > 0
    safe_wb = torch.where(wb > 0, wb, 1.0)
    dinv_sqrt = torch.where(pd_ok, 1.0 / torch.sqrt(safe_wb),
                            float("nan")).to(f.dtype)
    f = f * dinv_sqrt[None, :]
    a_dev = a.to(mesh.device)
    a2 = f.T @ a_dev @ f
    del a_dev
    a2 = 0.5 * (a2 + a2.T)
    if mode == "N":
        w, z = distributed_eigen_s(a2, mesh, mode="N", config=cfg)
    else:
        w, z2 = distributed_eigen_s(a2, mesh, nvec=nvec, config=cfg)
        z = _gev_back(f, z2, mesh, n)
    if not with_info:
        return w, z
    device_sync(w, z)
    elapsed = time.perf_counter() - t0
    # the two inner solves, and one redistribution for each of the three
    # products (the JAX package's model, distributed.py:520-522)
    stats = _dist_comm_stats(n, n, "A", cfg, mesh, a.dtype)
    stats.merge(_dist_comm_stats(n, nvec, mode, cfg, mesh, a.dtype))
    stats.record("redist", 3 * n * n * a.dtype.itemsize, 3)
    info = SolveInfo(flops=gev_flop_model(n, nvec, mode), elapsed=elapsed,
                     comm_time=stats.seconds(*_mesh_overheads(mesh)),
                     n=n, nvec=nvec, mode=mode, comm_stats=stats)
    return w, z, info


def independent_solves(a_batch, mesh, nvec: Optional[int] = None,
                       mode: str = "A",
                       config: Optional[SolverConfig] = None):
    """k independent eigenproblems over the mesh's ranks, the data-parallel
    mode of the reference benchmark (-g: every rank solves on its own,
    benchmark/main2.f:163-174).

    Rank r (flat order) solves problems r, r + P, … with the single-device
    ``eigen_s`` on its own device: no padding problem is solved.  Every
    rank gets all results: (w (k, n) float64, Z (k, n, nvec) or None in
    mode N)."""
    cfg = config or SolverConfig()
    a_batch = _local(a_batch)
    k, n = a_batch.shape[0], a_batch.shape[1]
    nvec = n if nvec is None else min(nvec, n)
    p, r = mesh.size, mesh.flat
    per = -(-k // p)
    ctx = EigenContext(device=mesh.device, config=cfg)
    dev = mesh.device
    w_loc = torch.zeros((per, n), dtype=torch.float64, device=dev)
    z_loc = (None if mode.upper() == "N" else
             torch.zeros((per, n, nvec), dtype=a_batch.dtype, device=dev))
    for j, i in enumerate(range(r, k, p)):
        w, z, _ = eigen_s(a_batch[i].to(dev), nvec=nvec, mode=mode, ctx=ctx)
        w_loc[j] = w
        if z_loc is not None:
            z_loc[j] = z

    def gather(x):
        # piece j of rank r is problem j·P + r
        parts = all_gather(x, mesh, GRID, tiled=False)
        return parts.transpose(0, 1).reshape(per * p, *x.shape[1:])[:k]

    return gather(w_loc), None if z_loc is None else gather(z_loc)


def training_step(mesh, n: int = 32, dtype=torch.float32):
    """One whole distributed solve, the framework's analogue of a training
    step (JAX ``training_step``, distributed.py:617): Frank n in `dtype` on
    the mesh's device through ``distributed_eigen_s`` with panels of 8 and
    16.  Every rank of the mesh calls it.  Returns (w, the whole Z on every
    rank, ‖A·Z − Z·diag(w)‖_F / ‖A‖_F)."""
    a = frank(n, dtype, mesh.device)
    cfg = SolverConfig(panel_forward=8, panel_backward=16)
    w, z = distributed_eigen_s(a, mesh, config=cfg)
    z = gather_matrix(z, mesh, (n, n))
    resid = (torch.linalg.norm(a @ z - z * w[None, :].to(z.dtype))
             / torch.linalg.norm(a))
    return w, z, resid
