"""Blocked Householder tridiagonalization and compact-WY helpers (real
symmetric and complex Hermitian).

Counterpart of ``eigenexa_tpu/ops/householder.py``.  Two implementations
of the reference's panel loop (src/eigen_trd.F:349), both a Python loop over
panels on ONE working matrix:

* **rolled**: each panel factors ``nb`` columns of the live trailing block
  (a strided view), reading it with a full matvec; the rank-2nb trailing
  update runs in place on the view ``A[k+nb:, k+nb:]`` through the
  hand-written ``sub_matmul`` kernel (``ops/kernels.rank2k_update``).  The
  reflectors go to a second n×n matrix.
* **windowed**: rows keep their global indices in the fixed buffer.  A
  window ``[t0·TM:, t0·TM:]`` that shrinks group by group bounds the work
  to the live trailing block.  The panel matvec reads only the window's
  lower triangle and applies the panel's corrections in the same call
  (``kernels.symv_lower``, into one workspace per reduction), the
  trailing update runs in place on the window
  (``kernels.rank2k_update_window``), and each panel's reflectors are
  stored in its own dead columns of the working matrix, so the reduction
  needs one n×n buffer, as the reference does.

The JAX package's scan bucketing, up-left roll, per-group jit, donation
decorators and the padding of n to a multiple of TM exist only for XLA and
the Pallas grid and are not ported.

The panel recurrence reads the trailing block as it stood at panel start
and corrects each column with the in-panel U and W; the in-place update
therefore runs strictly after the panel's last column (one stream, so call
order is enough).

One code path serves real and complex input on the rolled reduction, as in
the JAX package: reflectors follow zlarfg (β real), so a Hermitian matrix
reduces to a real tridiagonal T, and the conjugates sit where the formulas
need them (for a real tensor ``conj`` is the tensor itself).  The windowed
reduction is real only, as the JAX package's is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenexa_tpu_torch.ops.kernels import (WIN_TM, rank2k_update,
                                            rank2k_update_window, symv_lower,
                                            symv_workspace, wy_apply)

# dispatch override for tridiagonalize(impl="auto") and band2_reduce,
# settable by assignment: "rolled" / "windowed" force; "auto" takes the
# memory rule (_auto_impl) on a real CUDA tensor and is rolled otherwise.
TRD_IMPL = "auto"

# The memory rule (reference: _rolled_peak_bytes / _needs_windowed,
# eigenexa_tpu/ops/householder.py:378-390, with the card's own constants).
# A whole rolled solve peaks above what is in use when its reduction starts
# (the caller's input and the scaled working matrix) at
#     PEAK_N2[band]·n²·itemsize + PEAK_MERGE[band]·m·w·8 bytes:
# the reflectors V, held through the D&C, and the f64 secular work of the
# widest merge that is not panel-chunked, which sets the peak (m the D&C's
# padded size, w that merge's width: m/w merges of w² each).  band 1 is
# eigen_s, band 2 eigen_sx.  PEAK_MERGE is the least that covers the f32
# peaks at n = 8192, 16384 and 32768 of ``chip_smoke.py --findings``
# (memory; NVIDIA H100 80GB HBM3, 700 W): 15.01, 7.44 and 3.71 n²·4 bytes
# (eigen_s), 17.02, 8.45 and 4.21 (eigen_sx).  The same peak is measured
# through either reduction, so where the rolled solve does not fit the
# windowed one rarely does; it needs one n² buffer less while it reduces.
PEAK_N2 = {1: 1.0, 2: 1.0}
PEAK_MERGE = {1: 7.01, 2: 8.01}


class TridiagResult(NamedTuple):
    d: torch.Tensor     # (n,)  diagonal of T
    e: torch.Tensor     # (n-1,) sub-diagonal of T
    v: torch.Tensor     # (n, n) Householder vectors; column k holds the
                        #        reflector zeroing A[k+2:, k] (rows <= k are
                        #        0, row k+1 is 1)
    tau: torch.Tensor   # (n,) reflector scales (tau[k]=0 -> identity)


def householder_vector(x: torch.Tensor, p: int):
    """dlarfg/zlarfg analogue: the reflector (v, tau, beta) that maps x[p:]
    onto beta·e_p, annihilating x[p+1:] below the pivot alpha = x[p].

    The JAX function takes the mask ``idx > j``; here the pivot is the
    Python int p = j + 1, so the tail is a slice instead of a mask.  Returns
    v (v[p] = 1, zero above p), tau (0 when there is nothing to do) and
    beta, the resulting sub-diagonal value, which is real: for complex x
    the zlarfg convention rotates the pivot's phase into the reflector, and
    the reflector is active when the tail is nonzero or alpha is not real
    (so an empty tail still yields the phase rotation of the last
    sub-diagonal).  The tail is pre-scaled by its max-abs before the norm
    (dlarfg's rescaling), so ‖x‖² cannot overflow or underflow in f32.
    """
    m = x.shape[0]
    v = torch.zeros_like(x)
    zero = x.new_zeros(())
    rzero = x.real.new_zeros(())
    if p >= m:
        return v, zero, rzero
    alpha = x[p]
    tail = x[p + 1:]
    tiny = torch.finfo(x.dtype).tiny
    if tail.numel():
        scale = torch.clamp_min(tail.abs().amax(), tiny)
        xnorm = torch.linalg.vector_norm(tail / scale) * scale
    else:
        xnorm = rzero
    if x.is_complex():
        alphr, alphi = alpha.real, alpha.imag
        mag = torch.sqrt(alphr * alphr + alphi * alphi + xnorm * xnorm)
        active = (xnorm > 0) | (alphi != 0)
    else:
        alphr = alpha
        mag = torch.sqrt(alpha * alpha + xnorm * xnorm)
        active = xnorm > 0
    beta = torch.where(alphr >= 0, -mag, mag)   # real, opposite sign of Re α
    one = torch.ones_like(beta)
    safe_beta = torch.where(active, beta, one)
    tau = torch.where(active, (safe_beta - alpha) / safe_beta, zero)
    denom = torch.where(active, alpha - safe_beta, one.to(x.dtype))
    v[p + 1:] = tail / denom
    v[p] = active.to(x.dtype)
    return v, tau, torch.where(active, beta, alphr)


def _panel_body(j: int, b, u_p, w_p, tau_p, e_p):
    """One column of the [dz]latrd-style panel recurrence, in place on the
    panel buffers.  b is the (frozen) trailing block at panel start."""
    # the column as updated by the previous in-panel rank-2 updates:
    # A_cur[:, j] = B[:, j] − U·conj(W[j]) − W·conj(U[j])
    col = b[:, j] - u_p @ w_p[j].conj() - w_p @ u_p[j].conj()
    v, tau, beta = householder_vector(col, j + 1)
    # q = A_cur·v (reference: eigen_trd_au, src/eigen_trd_t2.F:161)
    q = b @ v - u_p @ (w_p.conj().T @ v) - w_p @ (u_p.conj().T @ v)
    # w = tau·q − (|tau|²/2)·(vᴴq)·v so that Hᴴ·A·H = A − v·wᴴ − w·vᴴ
    # (reference: eigen_trd_compute_v, src/eigen_trd_t6_3.F:85)
    w = tau * q - (tau * tau.conj() * 0.5) * torch.vdot(v, q) * v
    u_p[:, j] = v
    w_p[:, j] = w
    tau_p[j] = tau
    e_p[j] = beta


def tridiag_panel(b: torch.Tensor, nb: int):
    """Factor ``nb`` columns of the trailing matrix ``b`` (m×m).

    Returns (u_panel, w_panel, tau, e): after this the trailing update is
    b[nb:, nb:] -= U[nb:]·W[nb:]ᴴ + W[nb:]·U[nb:]ᴴ.  e is real.
    """
    m = b.shape[0]
    u_p = b.new_zeros((m, nb))
    w_p = b.new_zeros((m, nb))
    tau_p = b.new_zeros((nb,))
    e_p = b.real.new_zeros((nb,))
    for j in range(nb):
        _panel_body(j, b, u_p, w_p, tau_p, e_p)
    return u_p, w_p, tau_p, e_p


def _panel_diag(b, u_p, w_p, nb: int):
    """Real diagonal of the updated panel columns:
    d_j = Re(B[j,j]) − 2·Σ_l Re(U[j,l]·conj(W[j,l]))."""
    return (b.diagonal()[:nb].real
            - 2.0 * (u_p[:nb] * w_p[:nb].conj()).real.sum(dim=1))


def _tridiagonalize_rolled(work: torch.Tensor, nb: int) -> TridiagResult:
    """Rolled reduction; ``work`` is the working matrix and is destroyed.
    d and e are real whatever ``work`` is; v and tau are in its dtype."""
    n = work.shape[0]
    d = work.real.new_zeros((n,))
    e = work.real.new_zeros((max(n - 1, 1),))
    v_full = work.new_zeros((n, n))
    tau_full = work.new_zeros((n,))

    k = 0
    while n - k > nb:
        b = work[k:, k:]
        u_p, w_p, tau_p, e_p = tridiag_panel(b, nb)
        d[k:k + nb] = _panel_diag(b, u_p, w_p, nb)
        # rank-2nb trailing update, in place on the live block
        # (reference: eigen_common_2update, src/eigen_t1.F:68)
        trail = b[nb:, nb:]
        rank2k_update(trail, u_p[nb:], w_p[nb:], out=trail)
        e[k:k + nb] = e_p
        v_full[k:, k:k + nb] = u_p
        tau_full[k:k + nb] = tau_p
        k += nb

    # remainder block (m <= nb): factor its columns; no trailing update
    m = n - k
    if m > 1:
        b = work[k:, k:]
        u_p, w_p, tau_p, e_p = tridiag_panel(b, m)
        d[k:] = _panel_diag(b, u_p, w_p, m)
        e[k:k + m - 1] = e_p[:m - 1]
        v_full[k:, k:] = u_p
        tau_full[k:] = tau_p
    elif m == 1:
        d[k] = work[k, k].real
    return TridiagResult(d=d, e=e[:n - 1], v=v_full, tau=tau_full)


# ---------------------------------------------------------------------------
# windowed (no-roll) reduction
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _panel_win(b: torch.Tensor, j0: int, t0: int, nb: int, ws: dict):
    """latrd panel recurrence in the fixed-buffer windowed frame: rows keep
    their global indices, the panel's columns are j0 … j0+nb−1, the active
    window is ``[t0·TM:, t0·TM:]``, and the matvec reads only the window's
    lower triangle (``kernels.symv_lower``), which also applies the panel's
    corrections ``−U·(Wᵀv) − W·(Uᵀv)`` in its summing pass.  U and W are
    the two halves of one (n, 2nb) buffer; ``ws`` is the matvec's
    workspace (``kernels.symv_workspace``), made once per reduction.

    Rows of b above the current panel hold stale (already-processed) data,
    and so do the columns between the window's start and j0.  Every vector
    that could carry them into live values is cut: v is zero above its
    pivot, and w is zeroed on rows < j0.  That also keeps the stale region
    from being written, so staleness stays bounded by the original matrix
    magnitude instead of compounding.  Rows [t0·TM, j0) of the matvec are
    garbage by design and die in that cut; rows above t0·TM are zero.
    """
    n = b.shape[0]
    uw = b.new_zeros((n, 2 * nb))
    u_p, w_p = uw[:, :nb], uw[:, nb:]
    tau_p = b.new_zeros((nb,))
    e_p = b.new_zeros((nb,))
    for jc in range(nb):
        j = j0 + jc
        col = b[:, j] - u_p @ w_p[j] - w_p @ u_p[j]
        v, tau, beta = householder_vector(col, j + 1)
        # q = A_cur·v: the window's matvec less the panel's first jc
        # columns' corrections (U and W are zero above j0 >= t0·TM)
        q = symv_lower(b, v, t0=t0, panel=uw, nb=jc, **ws)
        w = tau * q - (tau * tau * 0.5) * torch.dot(v, q) * v
        w[:j0] = 0
        u_p[:, jc] = v
        w_p[:, jc] = w
        tau_p[jc] = tau
        e_p[jc] = beta
    return u_p, w_p, tau_p, e_p


def _win_schedule(n: int, nb: int, group: int):
    """Panel offsets per window group: group g covers offsets
    [g·group, (g+1)·group); returns ({g: [offsets]}, first remainder k)."""
    groups: dict = {}
    k = 0
    while n - k > nb:
        groups.setdefault(k // group, []).append(k)
        k += nb
    return groups, k


def _win_group_size(n: int, nb: int) -> int:
    """Columns per window group: an eighth of the matrix, at least four
    panels, in whole windows — the JAX package's rule, computed from n
    rounded up to TM as there, so that both use the same window at every
    panel."""
    return _round_up(max(4 * nb, _round_up(n, WIN_TM) // 8), WIN_TM)


def _tridiagonalize_windowed(b: torch.Tensor, nb: int) -> TridiagResult:
    """No-roll reduction on ONE fixed (n, n) working buffer ``b``, which is
    consumed and comes back as the result's v.

    Panels advance down the diagonal in the global frame.  After a panel's
    trailing update its (dead) columns are overwritten with the panel's
    reflectors — the reference's scheme of factoring A in place and keeping
    V in the zeroed-out part of the reduced matrix (src/eigen_trd.F:349;
    src/eigen_trd_t7.F:72,208).  Later panels never read those columns as
    data: the rank-2k delta there is exactly zero (both U and the j0-cut W
    vanish on rows < j0), and the windowed matvec's reads of them only feed
    rows that the recurrence cuts away.
    """
    n = b.shape[0]
    d = b.new_zeros((n,))
    e = b.new_zeros((max(n - 1, 1),))
    tau_full = b.new_zeros((n,))

    group = _win_group_size(n, nb)
    groups, k = _win_schedule(n, nb, group)
    # the matvec's q and scratch, sized for the first window; later, smaller
    # windows use leading slices of them
    ws = symv_workspace(b, panel_cols=2 * nb)
    for g in sorted(groups):
        t0 = (g * group) // WIN_TM
        for j0 in groups[g]:
            u_p, w_p, tau_p, e_p = _panel_win(b, j0, t0, nb, ws)
            rows = slice(j0, j0 + nb)
            d[rows] = (b.diagonal()[rows]
                       - 2.0 * (u_p[rows] * w_p[rows]).sum(dim=1))
            rank2k_update_window(b, u_p, w_p, t0=t0)
            # store V in place of the just-processed (dead) panel columns
            b[:, rows] = u_p
            tau_full[rows] = tau_p
            e[rows] = e_p

    # remainder panel (m <= nb) on the live corner, which the full-square
    # window update keeps current in both triangles
    m = n - k
    if m > 1:
        b_rem = b[k:, k:]
        u_p, w_p, tau_p, e_p = tridiag_panel(b_rem, m)
        d[k:] = _panel_diag(b_rem, u_p, w_p, m)
        e[k:k + m - 1] = e_p[:m - 1]
        b[:k, k:] = 0
        b[k:, k:] = u_p
        tau_full[k:] = tau_p
    elif m == 1:
        d[k] = b[k, k]
        b[:, k] = 0
    return TridiagResult(d=d, e=e[:n - 1], v=b, tau=tau_full)


def _rolled_peak_bytes(n: int, itemsize: int = 4, band: int = 1) -> float:
    """The whole rolled solve's peak above what is in use when its
    reduction starts (see ``PEAK_N2``), from the D&C's own chunk width."""
    from eigenexa_tpu_torch.solvers import dc_band, dc_tree, solver

    m, _ = dc_tree._pad_sizes(n, solver._DC_LEAF)
    w = m
    while w >= (dc_tree if band == 1 else dc_band)._LEVEL_CHUNK_MIN:
        w //= 2
    return PEAK_N2[band] * n * n * itemsize + PEAK_MERGE[band] * m * w * 8.0


def _needs_windowed(n: int, mem_bytes: float, itemsize: int = 4,
                    band: int = 1) -> bool:
    """The pure memory rule: the rolled solve does not fit 0.9 of the
    device memory free to the solve."""
    return _rolled_peak_bytes(n, itemsize, band) > 0.9 * mem_bytes


def _free_bytes(device) -> int:
    """Device memory free to a solve on ``device``: what the driver reports
    free (``torch.cuda.mem_get_info``) and what PyTorch's allocator holds
    unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _auto_impl(a: torch.Tensor, band: int) -> str:
    """What "auto" picks: the windowed reduction for a real CUDA tensor
    whose rolled solve does not fit, else rolled (a CPU or complex tensor
    always).  Where neither fits, the windowed one runs and its
    out-of-memory error rises."""
    if a.device.type != "cuda" or a.is_complex():
        return "rolled"
    n = a.shape[0]
    return ("windowed" if _needs_windowed(n, _free_bytes(a.device),
                                          a.element_size(), band)
            else "rolled")


def tridiagonalize(a: torch.Tensor, nb: int = 64, impl: str = "auto",
                   donate: bool = False) -> TridiagResult:
    """Reduce symmetric or Hermitian A (n×n) to real tridiagonal
    T = Qᴴ·A·Q.

    Q = H_0·H_1·…·H_{n-2}; reflector k is stored in column k of the
    returned v (for real A the last one is the identity; for Hermitian A it
    is the phase rotation that makes the last sub-diagonal real).
    Reference: src/eigen_trd.F:82 (real), src/eigen_hrd.F:1 (complex).
    Complex A takes the rolled reduction only.  With ``donate=True``
    ``a`` is the working matrix and is destroyed (the solver passes its
    scaled temporary); otherwise it is copied first.

    ``impl`` is "rolled", "windowed" or "auto"; "auto" follows the module's
    ``TRD_IMPL`` and, if that is "auto" too, the memory rule
    (:func:`_auto_impl`).  The windowed path returns its working matrix as
    v, so with ``donate=True`` it allocates no second n×n buffer.
    """
    if impl == "auto":
        impl = TRD_IMPL
    if impl == "auto":
        impl = _auto_impl(a, band=1)
    if impl not in ("rolled", "windowed"):
        raise ValueError(f"tridiagonalize: unknown impl {impl!r}")
    if impl == "windowed" and a.is_complex():
        raise NotImplementedError(
            "tridiagonalize: the windowed reduction is real only (a "
            "Hermitian reduction is rolled, as in the JAX package)")
    work = a if donate else a.clone(memory_format=torch.contiguous_format)
    if impl == "windowed":
        return _tridiagonalize_windowed(work, nb)
    return _tridiagonalize_rolled(work, nb)


# ---------------------------------------------------------------------------
# compact WY: T factor and blocked application (back-transform building block)
# ---------------------------------------------------------------------------

def wy_t_factor(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Upper-triangular T with H_0·…·H_{b-1} = I − V·T·Vᴴ (dlarft analogue,
    reference: src/trbakwy4_body.F, src/hrbakwy4_body.F), from the closed
    form T⁻¹ = diag(1/τ) + strict_upper(VᴴV) and one triangular solve."""
    return wy_t_from_gram(v.conj().T @ v, tau)


def wy_t_from_gram(g: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """`wy_t_factor` from a precomputed Gram matrix G = VᵀV.  Columns with
    τ = 0 have v = 0 and drop out (their diagonal entry is 1)."""
    nb = tau.shape[0]
    nz = tau != 0
    inv_tau = torch.where(nz, 1.0 / torch.where(nz, tau, 1.0), 1.0)
    t_inv = torch.triu(g, diagonal=1) + torch.diag(inv_tau)
    eye = torch.eye(nb, dtype=g.dtype, device=g.device)
    return torch.linalg.solve_triangular(t_inv, eye, upper=True)


def apply_wy_left(z: torch.Tensor, v: torch.Tensor, t: torch.Tensor):
    """Z ← (I − V·T·Vᴴ)·Z in place — one WY block of the back-transform
    (reference: src/trbakwy4_body.F:573-625,721).  The large second
    product streams through the fused subtract-matmul kernel."""
    return wy_apply(z, v, t, out=z)
