"""Blocked Householder tridiagonalization and compact-WY helpers (real
symmetric and complex Hermitian).

Counterpart of ``eigenexa_tpu/ops/householder.py``.  One panel loop
(``_tridiagonalize``, the reference's src/eigen_trd.F:349) on ONE working
matrix, in one of two frames decided once a reduction:

* **rolled** (``_Rolled``): each panel factors ``nb`` columns of the live
  trailing block (a strided view), reading it with a full matvec; the
  rank-2nb trailing update runs in place on the view through the
  hand-written ``sub_matmul`` kernel; the reflectors go to a second n×n
  matrix.
* **windowed** (``_Windowed``): rows keep their global indices in the fixed
  buffer, a window that shrinks group by group bounds the work, the panel
  matvec reads only the window's lower triangle and applies the panel's
  corrections in the same call (``kernels.symv_lower``), and each panel's
  reflectors go to its own dead columns, so the reduction needs one n×n
  buffer, as the reference does.

A real column is one body in either frame (``_real_columns``): its
reflector from ``kernels.householder_vector`` (one launch of
``csrc/householder.cu`` on the card), the frame's matvec, and w with the
panel's stores from ``kernels.column_update`` (one call of the same
source, three launches; two where the matvec applied the corrections).

The JAX package's scan bucketing, up-left roll, per-group jit, donation
decorators and the padding of n to a multiple of TM exist only for XLA and
the Pallas grid and are not ported.

The panel recurrence reads the trailing block as it stood at panel start
and corrects each column with the in-panel U and W; the in-place update
therefore runs strictly after the panel's last column (one stream, so call
order is enough).

Complex input takes the rolled frame only, as in the JAX package:
reflectors follow zlarfg (β real), so a Hermitian matrix reduces to a real
tridiagonal T, and its column runs op by op (``_panel_body_complex``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenexa_tpu_torch.ops.kernels import (WIN_TM, column_update,
                                            column_update_scratch,
                                            householder_vector,
                                            rank2k_update,
                                            rank2k_update_window, symv_lower,
                                            symv_workspace, wy_apply)
from eigenexa_tpu_torch.utils.profiler import span

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


def _real_columns(b, j0: int, u_p, w_p, tau_p, e_p, matvec, corrections):
    """The [dz]latrd-style recurrence over a panel's real columns, in place
    on the panel buffers; b is the (frozen) matrix at panel start.  The
    panel's frame gives the row of its first column in b (``j0``), the
    matvec ``matvec(v, jc)`` and whether ``column_update`` applies the
    panel's corrections.  Spans: form, reflector, matvec, w."""
    scratch = column_update_scratch(u_p)
    for jc in range(u_p.shape[1]):
        j = j0 + jc
        with span("trd.column"):
            with span("trd.column.form"):
                col = b[:, j] - u_p @ w_p[j] - w_p @ u_p[j]
            with span("trd.column.reflector"):
                v, tau, _ = householder_vector(col, j + 1,
                                               tau_out=tau_p[jc],
                                               beta_out=e_p[jc])
            with span("trd.column.matvec"):
                q = matvec(v, jc)
            with span("trd.column.w"):
                column_update(q, u_p, w_p, jc, v, tau,
                              corrections=corrections, zero_rows=j0,
                              scratch=scratch)
    return u_p, w_p, tau_p, e_p


def _panel_body_complex(j: int, b, u_p, w_p, tau_p, e_p):
    """One complex (Hermitian) column of the panel recurrence, op by op."""
    # the column as updated by the previous in-panel rank-2 updates:
    # A_cur[:, j] = B[:, j] − U·conj(W[j]) − W·conj(U[j])
    with span("trd.column.form"):
        col = b[:, j] - u_p @ w_p[j].conj() - w_p @ u_p[j].conj()
    with span("trd.column.reflector"):
        v, tau, beta = householder_vector(col, j + 1)
    # q = A_cur·v (reference: eigen_trd_au, src/eigen_trd_t2.F:161)
    with span("trd.column.matvec"):
        q = b @ v - u_p @ (w_p.conj().T @ v) - w_p @ (u_p.conj().T @ v)
    # w = tau·q − (|tau|²/2)·(vᴴq)·v so that Hᴴ·A·H = A − v·wᴴ − w·vᴴ
    # (reference: eigen_trd_compute_v, src/eigen_trd_t6_3.F:85)
    with span("trd.column.w"):
        w = tau * q - (tau * tau.conj() * 0.5) * torch.vdot(v, q) * v
        u_p[:, j] = v
        w_p[:, j] = w
        tau_p[j] = tau
        e_p[j] = beta


def tridiag_panel(b: torch.Tensor, nb: int):
    """Factor ``nb`` columns of the trailing matrix ``b`` (m×m): the rolled
    frame's panel.

    Returns (u_panel, w_panel, tau, e): after this the trailing update is
    b[nb:, nb:] -= U[nb:]·W[nb:]ᴴ + W[nb:]·U[nb:]ᴴ.  e is real.  A real
    column's matvec is the one trailing product B·v (reference:
    eigen_trd_au, src/eigen_trd_t2.F:161), the corrections following inside
    ``column_update``.
    """
    m = b.shape[0]
    u_p = b.new_zeros((m, nb))
    w_p = b.new_zeros((m, nb))
    tau_p = b.new_zeros((nb,))
    e_p = b.real.new_zeros((nb,))
    if not b.is_complex():
        return _real_columns(b, 0, u_p, w_p, tau_p, e_p,
                             lambda v, jc: b @ v, True)
    for j in range(nb):
        with span("trd.column"):
            _panel_body_complex(j, b, u_p, w_p, tau_p, e_p)
    return u_p, w_p, tau_p, e_p


def _panel_diag(b, u_p, w_p, nb: int):
    """Real diagonal of the updated panel columns:
    d_j = Re(B[j,j]) − 2·Σ_l Re(U[j,l]·conj(W[j,l]))."""
    return (b.diagonal()[:nb].real
            - 2.0 * (u_p[:nb] * w_p[:nb].conj()).real.sum(dim=1))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _panel_win(b: torch.Tensor, j0: int, t0: int, nb: int, ws: dict):
    """The windowed frame's panel: rows keep their global indices, the
    panel's columns are j0 … j0+nb−1, the active window is
    ``[t0·TM:, t0·TM:]``, and the matvec reads only the window's lower
    triangle (``kernels.symv_lower``), which also applies the panel's
    corrections ``−U·(Wᵀv) − W·(Uᵀv)`` in its summing pass (U and W are
    zero above j0 ≥ t0·TM).  U and W are
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
    tau_p = b.new_zeros((nb,))
    e_p = b.new_zeros((nb,))
    return _real_columns(
        b, j0, uw[:, :nb], uw[:, nb:], tau_p, e_p,
        lambda v, jc: symv_lower(b, v, t0=t0, panel=uw, nb=jc, **ws), False)


def _win_schedule(n: int, nb: int, group: int, spare: int = 0):
    """Panel offsets per window group, while more than nb + ``spare`` rows
    are live: group g covers offsets [g·group, (g+1)·group); returns
    ({g: [offsets]}, first remainder k)."""
    groups: dict = {}
    k = 0
    while n - k > nb + spare:
        groups.setdefault(k // group, []).append(k)
        k += nb
    return groups, k


def _win_group_size(n: int, nb: int) -> int:
    """Columns per window group: an eighth of the matrix, at least four
    panels, in whole windows — the JAX package's rule, computed from n
    rounded up to TM as there, so that both use the same window at every
    panel."""
    return _round_up(max(4 * nb, _round_up(n, WIN_TM) // 8), WIN_TM)


class _Rolled:
    """The rolled frame (see the module's docstring): panel k's U and W
    count rows from k, and its trailing update and V's store take the view
    ``work[k:, k:]``.  It reads no window: one group, t0 = 0."""

    windowed = False

    def __init__(self, work: torch.Tensor, nb: int):
        self.work, self.nb = work, nb
        self.v = work.new_zeros(work.shape)
        self.group = work.shape[0]

    def top(self, k: int) -> int:
        """The row of U that holds ``work``'s row k."""
        return 0

    def update(self, k: int, u_p, w_p, t0: int) -> None:
        # reference: eigen_common_2update, src/eigen_t1.F:68
        trail = self.work[k + self.nb:, k + self.nb:]
        rank2k_update(trail, u_p[self.nb:], w_p[self.nb:], out=trail)

    def store(self, k: int, u) -> None:
        """V's columns k … from U, whose rows are ``work``'s last."""
        self.v[k:, k:k + u.shape[1]] = u

    def identity(self, k: int) -> None:
        """V's column k is the identity's (V starts zeroed)."""


class _Windowed:
    """The windowed frame: panel k's U and W keep ``work``'s rows, and its
    V goes to its own dead columns of ``work``, which comes back as v (the
    reference's scheme, src/eigen_trd.F:349; src/eigen_trd_t7.F:72,208).
    Later panels never read those columns as data: the rank-2k delta there
    is exactly zero (both U and the j0-cut W vanish on rows < j0), and the
    windowed matvec's reads of them only feed rows that the recurrence cuts
    away.  The remainder runs on the live corner, which the full-square
    window update keeps current in both triangles."""

    windowed = True

    def __init__(self, work: torch.Tensor, nb: int):
        self.work, self.nb, self.v = work, nb, work
        self.group = _win_group_size(work.shape[0], nb)

    def top(self, k: int) -> int:
        return k

    def update(self, k: int, u_p, w_p, t0: int) -> None:
        rank2k_update_window(self.work, u_p, w_p, t0=t0)

    def store(self, k: int, u) -> None:
        top = self.v.shape[0] - u.shape[0]     # 0, or k for the corner
        if top:
            self.v[:top, k:] = 0               # the stale rows above it
        self.v[top:, k:k + u.shape[1]] = u

    def identity(self, k: int) -> None:
        self.v[:, k] = 0


def _tridiagonalize(work: torch.Tensor, nb: int,
                    frame_type) -> TridiagResult:
    """The panel loop, in the rolled or the windowed frame (``_Rolled``,
    ``_Windowed``); ``work`` is the working matrix and is destroyed (the
    windowed frame returns it as v).  d and e are real whatever ``work``
    is; v and tau are in its dtype."""
    n = work.shape[0]
    d = work.real.new_zeros((n,))
    e = work.real.new_zeros((max(n - 1, 1),))
    frame = frame_type(work, nb)
    tau_full = work.new_zeros((n,))
    if frame.windowed:
        # the matvec's q and scratch, sized for the first window; later,
        # smaller windows use leading slices of them
        ws = symv_workspace(work, panel_cols=2 * nb)
    groups, k = _win_schedule(n, nb, frame.group)
    for g in sorted(groups):
        t0 = (g * frame.group) // WIN_TM
        for j0 in groups[g]:
            with span("trd.panel"):
                if frame.windowed:
                    u_p, w_p, tau_p, e_p = _panel_win(work, j0, t0, nb, ws)
                else:
                    u_p, w_p, tau_p, e_p = tridiag_panel(work[j0:, j0:], nb)
                top = frame.top(j0)
                rows = slice(j0, j0 + nb)
                d[rows] = _panel_diag(work[j0:, j0:], u_p[top:], w_p[top:],
                                      nb)
                with span("trd.update"):
                    frame.update(j0, u_p, w_p, t0)
                e[rows] = e_p
                frame.store(j0, u_p)
                tau_full[rows] = tau_p

    # remainder block (m <= nb): factor its columns; no trailing update
    m = n - k
    if m > 1:
        with span("trd.panel"):
            b = work[k:, k:]
            u_p, w_p, tau_p, e_p = tridiag_panel(b, m)
            d[k:] = _panel_diag(b, u_p, w_p, m)
            e[k:k + m - 1] = e_p[:m - 1]
            frame.store(k, u_p)
            tau_full[k:] = tau_p
    elif m == 1:
        d[k] = work[k, k].real
        frame.identity(k)
    return TridiagResult(d=d, e=e[:n - 1], v=frame.v, tau=tau_full)


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
    return _tridiagonalize(work, nb,
                           _Windowed if impl == "windowed" else _Rolled)


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
