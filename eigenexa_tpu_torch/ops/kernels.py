"""The port's kernel wrappers: ``sub_matmul``, ``symv_lower``,
``rank2k_update_window``, ``sturm_bisect``, ``householder_vector``,
``column_update``, ``pair_reflectors`` and ``pair_update``.

Counterpart of ``eigenexa_tpu/ops/pallas_kernels.py``.  Each kernel is
hand-written CUDA for Hopper under ``csrc/`` (``sub_matmul.cu``,
``symv_lower.cu``, ``sturm.cu``, ``householder.cu``), built by
``ops/_build.py``:

* ``sub_matmul`` (with ``rank2k_update`` and ``wy_apply``): the fused
  subtract-matmul ``OUT = B − P·Qᴴ`` of the rolled reduction's trailing
  update and of every back-transform block;
* ``symv_lower``: the panel matvec of the windowed reduction, reading only
  the lower triangle of the window ``[t0·TM:, t0·TM:]``.  Handed the
  panel ``[U | W]``, it also applies the column's corrections
  ``−U·(Wᵀx) − W·(Uᵀx)`` in its summing pass, and handed a workspace
  (``out=``, ``scratch=``; ``symv_workspace`` makes one per reduction)
  it allocates nothing;
* ``rank2k_update_window``: the windowed reduction's trailing update, in
  place on the same window;
* ``sturm_bisect``: index-targeted Sturm bisection of a tridiagonal or
  pentadiagonal matrix (modes N and X), by multisection: a group of 2^L
  lanes owns an eigenvalue index and probes the 2^L − 1 midpoints of the
  next L bisection steps at once, which gives bisection's bits.  It is no
  TPU kernel's port: the JAX package runs the recurrence as a ``lax.scan``
  inside ``lax.fori_loop`` (``eigenexa_tpu/ops/sturm.py``), which eager
  PyTorch on the card could only issue launch by launch;
* ``householder_vector``: the reflector of one column (dlarfg, zlarfg) in
  one launch, where its jnp form, which XLA fuses inside the panel's
  program, is some 27 eager ops.  No TPU kernel's port either;
* ``column_update``: the real tridiagonal column's W after its trailing
  matvec, the panel's corrections of q, w and the column's stores into
  the panel, one call of three launches for some 19 eager ops.  No TPU
  kernel's port either;
* ``pair_reflectors``: the band-2 reduction's reflector pair (CholeskyQR2
  of two columns, their two reflectors and the 2×2 T) in one launch,
  where its eager form is some 43 ops; ``pair_update``: the pair's two
  columns of W and its stores into the panel, one launch for some 16
  ops.  No TPU kernel's port either.

``WIN_TM`` is the window granularity TM: a window starts at row and column
``t0·TM``.  It says nothing about the kernels' own tiles, and a matrix edge
need not be a multiple of it.

Dispatch is by device, never by a fallback:

* a CPU tensor takes the plain version (``_sub_matmul_ref``,
  ``_symv_lower_ref``, ``_rank2k_window_ref``, ``_sturm_bisect_ref``,
  ``_householder_vector_ref``, ``_column_update_ref``,
  ``_pair_reflectors_ref``, ``_pair_update_ref``); the parity tests and
  the CPU solver run it;
* a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (other dtypes, complex but for ``sub_matmul`` and
  ``householder_vector``, non-unit column stride, bad aliasing, more than
  ``SYMV_MAX_NC`` vectors, a window that starts past the matrix).

``sub_matmul`` takes f32, f64, c64 and c128 (``rank2k_update`` and
``wy_apply`` with it: their formulas carry the conjugates), and so does
``householder_vector``.  The windowed kernels are real only, as the JAX
package's windowed path is: a Hermitian reduction is always rolled.

``LAUNCHES`` counts wrapper calls that launched their kernel (the main
path's proof that it ran through the kernels); a plain version never
touches it.
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops._build import load_library

LAUNCHES = {"sub_matmul": 0, "symv_lower": 0, "rank2k_update_window": 0,
            "sturm_bisect": 0, "householder_vector": 0, "column_update": 0,
            "pair_reflectors": 0, "pair_update": 0}

WIN_TM = 512       # window granularity TM of the windowed reduction
SYMV_MAX_NC = 8    # most vectors one symv_lower call takes
_SYMV_TILE = 64    # tile rows of csrc/symv_lower.cu (sizes its scratch)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}
F64 = torch.float64


def _sub_matmul_ref(b, p, q):
    """Plain PyTorch version, with the complex conj semantics of the JAX
    fallback (``b - p @ jnp.conj(q).T``)."""
    return b - p @ q.conj().T


def _ld(x: torch.Tensor, name: str, fn: str = "sub_matmul") -> int:
    """Leading dimension of a row-major (unit column stride) 2-D view."""
    rows, cols = x.shape
    if cols > 1 and x.stride(1) != 1:
        raise ValueError(f"{fn}: {name} needs unit column stride, "
                         f"got strides {tuple(x.stride())}")
    if rows <= 1:
        return max(cols, 1)
    if x.stride(0) < cols:
        raise ValueError(f"{fn}: {name} rows overlap "
                         f"(strides {tuple(x.stride())}, shape {tuple(x.shape)})")
    return x.stride(0)


def _check_kernel_dtype(fn: str, b: torch.Tensor,
                        complex_ok: bool = False) -> None:
    """What every kernel refuses on a tensor that is not on the CPU."""
    if b.is_complex() and not complex_ok:
        raise NotImplementedError(
            f"{fn}: the windowed kernels are real only (a Hermitian "
            "reduction is rolled, as in the JAX package)")
    if b.dtype not in _SUFFIX:
        raise TypeError(f"{fn}: no kernel for dtype {b.dtype}")
    if b.device.type != "cuda":
        raise NotImplementedError(
            f"{fn}: no kernel for device {b.device.type!r}")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def _same_storage(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()


def _check(b, p, q, out):
    if b.ndim != 2 or p.ndim != 2 or q.ndim != 2:
        raise ValueError("sub_matmul: B, P and Q must be 2-D")
    m, n = b.shape
    if p.shape[0] != m or q.shape[0] != n or p.shape[1] != q.shape[1]:
        raise ValueError(f"sub_matmul: shapes B{tuple(b.shape)} "
                         f"P{tuple(p.shape)} Q{tuple(q.shape)} do not fit "
                         "B (m, n), P (m, k), Q (n, k)")
    tensors = (b, p, q) if out is None else (b, p, q, out)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sub_matmul: operands on different devices")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("sub_matmul: operands of different dtypes")
    if out is not None and out.shape != b.shape:
        raise ValueError(f"sub_matmul: out{tuple(out.shape)} != "
                         f"B{tuple(b.shape)}")


def sub_matmul(b, p, q, out=None):
    """``B − P·conj(Q)ᵀ`` with the subtract fused into the product.

    B: (m, n); P: (m, k); Q: (n, k); f32, f64, c64 or c128 (the kernel takes
    Q's conjugate as it loads it).  ``out`` may be B itself (the in-place
    trailing update); otherwise a new (m, n) tensor is returned.
    """
    _check(b, p, q, out)
    if b.device.type == "cpu":
        r = _sub_matmul_ref(b, p, q)
        if out is None:
            return r
        return out.copy_(r)
    _check_kernel_dtype("sub_matmul", b, complex_ok=True)
    if out is None:
        out = torch.empty_like(b, memory_format=torch.contiguous_format)
    m, n = b.shape
    if m == 0 or n == 0:
        return out
    if _same_storage(out, b) and (out.data_ptr() != b.data_ptr()
                                  or out.stride() != b.stride()):
        raise ValueError("sub_matmul: out overlaps B without being B")
    if _same_storage(out, p) or _same_storage(out, q):
        raise ValueError("sub_matmul: out must not share storage with P or Q")
    if any(x.is_conj() for x in (b, p, q, out)):
        # the kernel reads the stored values: a lazy conjugate is not there
        raise ValueError("sub_matmul: an operand carries a lazy conjugate; "
                         "pass it through resolve_conj()")
    ldb, ldp, ldq, ldo = (_ld(b, "B"), _ld(p, "P"), _ld(q, "Q"),
                          _ld(out, "out"))
    fn = getattr(load_library(), "eigenexa_sub_matmul_" + _SUFFIX[b.dtype])
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m, n, p.shape[1], b.data_ptr(), ldb, p.data_ptr(), ldp,
                 q.data_ptr(), ldq, out.data_ptr(), ldo, stream)
    _raise_on(err, "sub_matmul")
    LAUNCHES["sub_matmul"] += 1
    return out


def rank2k_update(b, u, w, out=None):
    """``B − U·conj(W)ᵀ − W·conj(U)ᵀ`` as one rank-2k pass
    (reference: eigen_common_2update, src/eigen_t1.F:68): the two rank-nb
    products become one contraction over the panel concatenations
    P = [U W], Q = [W U]."""
    p = torch.cat([u, w], dim=1)
    q = torch.cat([w, u], dim=1)
    return sub_matmul(b, p, q, out=out)


def wy_apply(z, v, t, out=None):
    """``Z − V·(T·(VᴴZ))`` — one WY back-transform block
    (reference: src/trbakwy4_body.F:573-625,721).  S = VᴴZ and T·S are
    plain products (they write only O(nb·nvec)); the large second product
    streams Z through the fused subtract kernel."""
    s = v.conj().T @ z
    y = t @ s
    return sub_matmul(z, v, y.mH.resolve_conj().contiguous(), out=out)


# ---------------------------------------------------------------------------
# the column's Householder reflector
# ---------------------------------------------------------------------------

def _householder_vector_ref(x: torch.Tensor, p: int):
    """Plain PyTorch version of :func:`householder_vector`, op by op."""
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


def householder_vector(x: torch.Tensor, p: int, tau_out=None,
                       beta_out=None):
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
    tau and beta are 0-d tensors on x's device; where ``tau_out`` or
    ``beta_out`` (one element each, of x's dtype and its real dtype, on x's
    device: a panel's slots) is given, the value is written there and it is
    returned.

    x: (m,), f32, f64, c64 or c128.  A CPU tensor, and a pivot past the end
    (p ≥ m: no reflector, nothing launched), take the plain version; a CUDA
    tensor launches ``csrc/householder.cu`` once, which agrees with the
    plain version to rounding (its two sums run in another, fixed, order),
    or raises on a non-unit stride or another dtype.
    """
    m = x.shape[0]
    if p >= m or x.device.type == "cpu":
        v, tau, beta = _householder_vector_ref(x, p)
        if tau_out is not None:
            tau = tau_out.copy_(tau)
        if beta_out is not None:
            beta = beta_out.copy_(beta)
        return v, tau, beta
    _check_kernel_dtype("householder_vector", x, complex_ok=True)
    if x.ndim != 1 or p < 0:
        raise ValueError(f"householder_vector: x{tuple(x.shape)} and p = {p} "
                         "are not a vector and a pivot inside it")
    if m > 1 and x.stride(0) != 1:
        raise ValueError("householder_vector: x needs unit stride, got "
                         f"{x.stride(0)}")
    if x.is_conj():
        # the kernel reads the stored values: a lazy conjugate is not there
        raise ValueError("householder_vector: x carries a lazy conjugate; "
                         "pass it through resolve_conj()")
    v = torch.empty((m,), dtype=x.dtype, device=x.device)
    tau = _scalar_out(tau_out, x.dtype, x.device, "tau_out")
    beta = _scalar_out(beta_out, x.dtype.to_real(), x.device, "beta_out")
    fn = getattr(load_library(),
                 "eigenexa_householder_vector_" + _SUFFIX[x.dtype])
    args = (m, p, x.data_ptr(), v.data_ptr(), tau.data_ptr(),
            beta.data_ptr())
    # the device guard is entered only where x's card is not current
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "householder_vector")
    LAUNCHES["householder_vector"] += 1
    return v, tau, beta


def _scalar_out(out, dtype, device, name: str):
    """A new 0-d tensor, or ``out`` where it is one element of ``dtype`` on
    ``device``."""
    if out is None:
        return torch.empty((), dtype=dtype, device=device)
    if out.numel() != 1 or out.dtype != dtype or out.device != device:
        raise ValueError(f"householder_vector: {name} must be one element "
                         f"of {dtype} on {device}")
    return out


def _pair_reflectors_ref(x: torch.Tensor, c0: int, tau_out=None):
    """Plain PyTorch version of :func:`pair_reflectors`, op by op."""
    x0, x1 = x[:, 0], x[:, 1]
    m = x0.shape[0]
    p = c0 + 2
    a0 = x0.clone()
    a0[:p] = 0
    a1 = x1.clone()
    a1[:p] = 0
    t11 = torch.dot(a0, a0)
    pos = t11 > 0
    safe_t11 = torch.where(pos, t11, torch.ones_like(t11))
    zero = torch.zeros_like(t11)
    for _ in range(2):           # CholeskyQR2: twice is enough
        s12 = torch.dot(a0, a1) / safe_t11
        a1 = a1 - torch.where(pos, s12, zero) * a0
    v0, tau0, beta0 = householder_vector(a0, p)
    p0 = min(p, m - 1)
    denom0 = torch.where(tau0 != 0, a0[p0] - beta0, torch.ones_like(tau0))
    vta1 = -beta0 * a1[p0] / denom0
    c1 = a1 - tau0 * vta1 * v0
    v1, tau1, _ = householder_vector(c1, p + 1)
    t01 = -tau0 * tau1 * torch.dot(v0, v1)
    t = torch.stack([torch.stack([tau0, t01]), torch.stack([zero, tau1])])
    tau = torch.stack([tau0, tau1])
    if tau_out is not None:
        tau_out.copy_(tau)
        tau = tau_out
    return torch.stack([v0, v1], dim=1), tau, t


def pair_reflectors(x: torch.Tensor, c0: int, tau_out=None):
    """The band-2 reflector pair of the columns x[:, 0], x[:, 1] (columns
    c0 and c0+1 of the reduction, pivots c0+2 and c0+3), the tall-skinny-QR
    scheme of eigen_prd_compute_u (src/eigen_prd_t4x.F:83):

    1. CholeskyQR2: the second column is orthogonalized against the first
       through its Gram coefficient, exactly twice (eigen_prd_t4x.F:140-283);
    2. reflector 0 from the first column, pivot row c0+2;
    3. H₀ applied to the orthogonalized second column analytically,
       v₀ᵀ·a₁ = −β₀·a₁[p₀]/(α₀−β₀), divided only where τ₀ ≠ 0 (the
       reference's rank-1 fix-up, eigen_prd_t4x.F:305);
    4. reflector 1 from the result, pivot row c0+3.

    Returns (V (m, 2), τ (2,), T (2, 2)) with H₀·H₁ = I − V·T·Vᵀ, T upper
    triangular; τ is written into ``tau_out`` (2 elements) where given.
    x: (m, 2), f32 or f64.  A CPU tensor, and a first pivot past the end
    (c0+2 ≥ m: no reflector, nothing launched), take the plain version; a
    CUDA tensor launches ``csrc/householder.cu`` once, which agrees with
    the plain version to rounding (its six sums run in another, fixed,
    order), or raises on a row whose two entries are not adjacent or on
    another dtype.
    """
    m = x.shape[0]
    if x.device.type == "cpu" or c0 + 2 >= m:
        return _pair_reflectors_ref(x, c0, tau_out)
    _check_kernel_dtype("pair_reflectors", x)
    if x.ndim != 2 or x.shape[1] != 2 or c0 < 0:
        raise ValueError(f"pair_reflectors: x{tuple(x.shape)} and c0 = {c0} "
                         "are not two columns and a pair inside them")
    if x.stride(1) != 1 or x.stride(0) < 2:
        raise ValueError("pair_reflectors: a row's two entries must be "
                         f"adjacent, got strides {x.stride()}")
    if tau_out is None:
        tau_out = torch.empty((2,), dtype=x.dtype, device=x.device)
    elif (tau_out.shape != (2,) or tau_out.dtype != x.dtype
          or tau_out.device != x.device or tau_out.stride(0) != 1):
        raise ValueError("pair_reflectors: tau_out must be 2 adjacent "
                         "elements of x's dtype on x's device")
    v = torch.empty((m, 2), dtype=x.dtype, device=x.device)
    t = torch.empty((2, 2), dtype=x.dtype, device=x.device)
    fn = getattr(load_library(),
                 "eigenexa_pair_reflectors_" + _SUFFIX[x.dtype])
    args = (m, c0 + 2, x.data_ptr(), x.stride(0), v.data_ptr(), 2,
            tau_out.data_ptr(), t.data_ptr())
    # the device guard is entered only where x's card is not current
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "pair_reflectors")
    LAUNCHES["pair_reflectors"] += 1
    return v, tau_out, t


PAIR_UPDATE_MAX_COLS = 256   # most earlier columns pair_update takes
_UPDATE_SLABS = 64           # most row slabs of csrc/householder.cu's updates


def _pair_update_ref(b_v, u_p, w_p, c0: int, v, t, zero_rows: int = 0):
    """Plain PyTorch version of :func:`pair_update`, op by op."""
    u, w = u_p[:, :c0], w_p[:, :c0]
    if c0:
        b_v = b_v - u @ (w.T @ v) - w @ (u.T @ v)
    p = b_v @ t
    s = t.T @ (v.T @ p)
    w_pair = p - 0.5 * (v @ s)
    if zero_rows:
        w_pair[:zero_rows] = 0
    w_p[:, c0:c0 + 2] = w_pair
    u_p[:, c0:c0 + 2] = v


def pair_update(b_v, u_p, w_p, c0: int, v, t, zero_rows: int = 0) -> None:
    """The reflector pair's two columns of W, P = (B·V − U·(WᵀV) −
    W·(UᵀV))·T and W = P − ½·V·(Tᵀ·Vᵀ·P), so that Hᵀ·A·H = A − V·Wᵀ −
    W·Vᵀ (the 2×2 coupling matrix of eigen_prd_compute_v,
    src/eigen_prd.F:363), stored with V into the panel: columns c0, c0+1
    of ``w_p`` and ``u_p``, whose first c0 columns are the panel's
    earlier U and W.  W's rows before ``zero_rows`` are set to zero (the
    windowed frame's stale rows).

    b_v: B·V (m, 2); u_p, w_p: (m, ≥ c0+2), one row stride; v: (m, 2);
    t: (2, 2); f32 or f64.  A CPU tensor takes the plain version; a CUDA
    tensor calls ``csrc/householder.cu`` once (three launches over slabs
    of the rows), which agrees with the plain version to rounding (its
    sums run in another, fixed, order), or
    raises on rows whose entries are not adjacent, on more than
    ``PAIR_UPDATE_MAX_COLS`` earlier columns or on another dtype.
    """
    if b_v.device.type == "cpu":
        return _pair_update_ref(b_v, u_p, w_p, c0, v, t, zero_rows)
    _check_kernel_dtype("pair_update", b_v)
    m = b_v.shape[0]
    mats = (b_v, u_p, w_p, v, t)
    if (any(x.dtype != b_v.dtype or x.device != b_v.device for x in mats)
            or any(x.ndim != 2 for x in mats) or b_v.shape != (m, 2)
            or v.shape != (m, 2) or t.shape != (2, 2)
            or u_p.shape != w_p.shape or u_p.shape[0] != m
            or not 0 <= c0 <= min(u_p.shape[1] - 2, PAIR_UPDATE_MAX_COLS)
            or zero_rows < 0):
        raise ValueError(f"pair_update: b_v{tuple(b_v.shape)}, "
                         f"u_p{tuple(u_p.shape)}, w_p{tuple(w_p.shape)}, "
                         f"v{tuple(v.shape)}, t{tuple(t.shape)} and c0 = "
                         f"{c0} are not one pair of one panel")
    if (any(x.stride(1) != 1 for x in mats) or not t.is_contiguous()
            or u_p.stride(0) != w_p.stride(0)
            or min(b_v.stride(0), v.stride(0)) < 2
            or u_p.stride(0) < u_p.shape[1]):
        raise ValueError("pair_update: every row's entries must be "
                         "adjacent, and u_p's rows w_p's stride apart")
    # the slabs' partial sums of Wᵀ·V, Uᵀ·V and Vᵀ·P
    scratch = torch.empty((_UPDATE_SLABS * (4 * c0 + 4),),
                          dtype=b_v.dtype, device=b_v.device)
    fn = getattr(load_library(), "eigenexa_pair_update_" + _SUFFIX[b_v.dtype])
    args = (m, c0, zero_rows, b_v.data_ptr(), b_v.stride(0),
            u_p.data_ptr(), w_p.data_ptr(), u_p.stride(0), v.data_ptr(),
            v.stride(0), t.data_ptr(), scratch.data_ptr())
    # the device guard is entered only where the card is not current
    if b_v.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(b_v.device).cuda_stream)
    else:
        with torch.cuda.device(b_v.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "pair_update")
    LAUNCHES["pair_update"] += 1


COLUMN_UPDATE_MAX_COLS = 256  # most correcting columns column_update takes
_COLUMN_UPDATE = {}           # dtype: its entry point, looked up once


def column_update_scratch(u_p):
    """The slabs' partial sums for :func:`column_update` calls on a panel
    as wide as ``u_p``, made once a panel; empty on the CPU, whose plain
    version needs none."""
    cols = min(u_p.shape[1], COLUMN_UPDATE_MAX_COLS)
    numel = (0 if u_p.device.type == "cpu"
             else _UPDATE_SLABS * (2 * cols + 1))
    return u_p.new_empty((numel,))


def _column_update_ref(b_v, u_p, w_p, j: int, v, tau,
                       corrections: bool = True, zero_rows: int = 0):
    """Plain PyTorch version of :func:`column_update`, op by op: the panel
    body's own ops, the corrections over the whole panel."""
    q = (b_v - u_p @ (w_p.T @ v) - w_p @ (u_p.T @ v) if corrections
         else b_v)
    w = tau * q - (tau * tau * 0.5) * torch.dot(v, q) * v
    if zero_rows:
        w[:zero_rows] = 0
    u_p[:, j] = v
    w_p[:, j] = w


def column_update(b_v, u_p, w_p, j: int, v, tau, *, corrections=True,
                  zero_rows: int = 0, scratch=None) -> None:
    """The tridiagonal column's w after its trailing matvec b_v = B·v:
    q = b_v − U·(Wᵀv) − W·(Uᵀv) over the panel's first j columns (where
    ``corrections``; else q = b_v, the windowed matvec having applied
    them), then w = τq − ½τ²(vᵀq)·v so that Hᵀ·A·H = A − v·wᵀ − w·vᵀ
    (reference: eigen_trd_au, src/eigen_trd_t2.F:161; eigen_trd_compute_v,
    src/eigen_trd_t6_3.F:85), stored with v as column j of ``w_p`` and
    ``u_p``.  W's rows before ``zero_rows`` are set to zero (the windowed
    frame's stale rows).  With ``corrections`` the panel's columns from j
    on must still be zero, as they are while a panel is formed: the plain
    version's products run over the whole panel.

    b_v, v: (m,); u_p, w_p: (m, > j), one row stride; tau: one element,
    read on the card; f32 or f64.  ``scratch`` (see
    :func:`column_update_scratch`) is the slabs' partial sums; left out, a
    call makes its own.  A CPU tensor takes the plain version; a CUDA
    tensor calls ``csrc/householder.cu`` once (three launches over slabs
    of the rows, two at no correction), which agrees with the plain
    version to rounding (its sums run in another, fixed, order), or raises
    on complex input, another dtype, a non-unit stride or more than
    ``COLUMN_UPDATE_MAX_COLS`` correcting columns.
    """
    if b_v.device.type == "cpu":
        return _column_update_ref(b_v, u_p, w_p, j, v, tau, corrections,
                                  zero_rows)
    fn = _COLUMN_UPDATE.get(b_v.dtype) if b_v.is_cuda else None
    if fn is None:
        _check_kernel_dtype("column_update", b_v)
        fn = _COLUMN_UPDATE[b_v.dtype] = getattr(
            load_library(), "eigenexa_column_update_" + _SUFFIX[b_v.dtype])
    # the checks are written for a column's host time: each attribute is
    # read once
    m = b_v.shape[0]
    c0 = j if corrections else 0
    dtype, device = b_v.dtype, b_v.device
    shape = u_p.shape
    if (b_v.dim() != 1 or v.shape != b_v.shape or len(shape) != 2
            or w_p.shape != shape or shape[0] != m
            or not 0 <= j < shape[1] or c0 > COLUMN_UPDATE_MAX_COLS
            or zero_rows < 0 or tau.numel() != 1):
        raise ValueError(f"column_update: b_v{tuple(b_v.shape)}, "
                         f"u_p{tuple(shape)}, w_p{tuple(w_p.shape)}, "
                         f"v{tuple(v.shape)}, tau{tuple(tau.shape)} and "
                         f"j = {j} are not one column of one panel")
    if (u_p.dtype != dtype or w_p.dtype != dtype or v.dtype != dtype
            or tau.dtype != dtype or u_p.device != device
            or w_p.device != device or v.device != device
            or tau.device != device):
        raise ValueError("column_update: operands of different dtypes or "
                         "devices")
    ldu, unit = u_p.stride()
    if (unit != 1 or w_p.stride() != (ldu, 1) or ldu < shape[1]
            or (m > 1 and (b_v.stride(0) != 1 or v.stride(0) != 1))):
        raise ValueError("column_update: b_v and v need unit stride, a "
                         "row's entries of u_p and w_p adjacent and their "
                         "rows one stride apart")
    need = _UPDATE_SLABS * (2 * c0 + 1)
    if scratch is None:
        scratch = torch.empty((need,), dtype=dtype, device=device)
    elif (scratch.numel() < need or scratch.dtype != dtype
          or scratch.device != device):
        raise ValueError(f"column_update: scratch must hold {need} "
                         f"elements of {dtype} on {device}")
    args = (m, c0, j, zero_rows, b_v.data_ptr(), u_p.data_ptr(),
            w_p.data_ptr(), ldu, v.data_ptr(), tau.data_ptr(),
            scratch.data_ptr())
    # the device guard is entered only where the card is not current
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "column_update")
    LAUNCHES["column_update"] += 1


# ---------------------------------------------------------------------------
# windowed reduction: symmetric matvec on the lower triangle, and the
# in-place trailing update of the window
# ---------------------------------------------------------------------------

def _window_start(fn: str, b: torch.Tensor, t0: int) -> int:
    if b.ndim != 2 or b.shape[0] != b.shape[1]:
        raise ValueError(f"{fn}: B must be square, got {tuple(b.shape)}")
    w0 = t0 * WIN_TM
    if t0 < 0 or w0 >= b.shape[0]:
        raise ValueError(f"{fn}: window start t0·TM = {w0} lies outside "
                         f"B{tuple(b.shape)}")
    return w0


def _symv_lower_ref(b, x, t0: int = 0, panel=None, nb=None):
    """Plain PyTorch version of :func:`symv_lower`.  The symmetric window
    is rebuilt from its lower triangle alone, so whatever the upper
    triangle holds never reaches the result.  With a panel the corrections
    are taken as the windowed column took them before they were fused,
    ``q − U @ (Wᵀ @ x) − W @ (Uᵀ @ x)``, on the window's rows."""
    w0 = t0 * WIN_TM
    low = torch.tril(b[w0:, w0:])
    full = low + torch.tril(low, diagonal=-1).T
    q = torch.zeros_like(x)
    xw = x[w0:]
    q[w0:] = full @ xw
    if panel is not None:
        half = panel.shape[1] // 2
        nb = half if nb is None else nb
        u, w = panel[w0:, :nb], panel[w0:, half:half + nb]
        q[w0:] = q[w0:] - u @ (w.T @ xw) - w @ (u.T @ xw)
    return q


def symv_scratch_numel(m: int, t0: int = 0, nc: int = 1,
                       panel_cols: int = 0) -> int:
    """Elements of ``scratch`` that a :func:`symv_lower` call on an (m, m)
    matrix at window t0 with nc vectors and a panel ``panel_cols`` wide
    needs: g = panelᵀ·x, then one slot per (source tile, vector, window
    row), counted for tiles of ``_SYMV_TILE`` on either side, which is
    enough for any tile width of the kernel.  A smaller window needs
    fewer, so a buffer sized for the first window of a reduction serves
    all of its later ones."""
    mw = m - t0 * WIN_TM
    return panel_cols + 2 * -(-mw // _SYMV_TILE) * nc * mw


def symv_workspace(b, t0: int = 0, nc: int = 1, panel_cols: int = 0):
    """``out=`` and ``scratch=`` for :func:`symv_lower` calls on B from
    window t0 on, allocated once.  The plain version needs no scratch, so
    on the CPU it is empty."""
    m = b.shape[0]
    numel = (0 if b.device.type == "cpu"
             else symv_scratch_numel(m, t0, nc, panel_cols))
    return {"out": b.new_empty((m,) if nc == 1 else (m, nc)),
            "scratch": b.new_empty((numel,))}


def _check_symv_workspace(b, x, panel, out, scratch):
    """The workspace fits B and shares storage with no operand and not
    with itself (each storage is looked up once: the column calls this
    every time)."""
    if out is None and scratch is None:
        return
    operands = {t.untyped_storage().data_ptr()
                for t in (b, x, panel) if t is not None}
    seen = set()
    for name, ws in (("out", out), ("scratch", scratch)):
        if ws is None:
            continue
        if ws.device != b.device or ws.dtype != b.dtype:
            raise ValueError(f"symv_lower: {name} must be {b.dtype} on "
                             f"{b.device}")
        if not ws.is_contiguous():
            raise ValueError(f"symv_lower: {name} must be contiguous")
        storage = ws.untyped_storage().data_ptr()
        if storage in operands or storage in seen:
            raise ValueError(f"symv_lower: {name} shares storage with an "
                             "operand or the other workspace tensor")
        seen.add(storage)
    if out is not None and out.shape != x.shape:
        raise ValueError(f"symv_lower: out{tuple(out.shape)} is not shaped "
                         f"like X{tuple(x.shape)}")


def symv_lower(b, x, t0: int = 0, *, panel=None, nb=None, out=None,
               scratch=None):
    """``Q = B·X`` for symmetric B stored full, reading only the lower
    triangle of the window ``[t0·TM:, t0·TM:]`` (TM = ``WIN_TM``).

    B: (m, m), any m; X: (m,) or (m, nc) with nc ≤ ``SYMV_MAX_NC`` (the
    band-2 pair recurrence passes nc = 2).  Rows above the window come back
    zero; inside the window row i is Σ_j S[i, j]·X[j] over the window's
    columns only, S the window's lower triangle mirrored.  The sum runs in
    a fixed order with no atomics, so two calls on equal inputs are bitwise
    equal.

    ``panel`` (X a vector only): an (m, 2·h) buffer ``[U | W]`` of the
    Householder panel, of which the first ``nb`` columns of each half are
    used (all h by default).  Then the window's rows of Q also lose the
    panel's corrections, ``U·(Wᵀx) + W·(Uᵀx)``, with every product over the
    window's rows: on the card the summing pass applies them, after one
    ``torch.mv`` for g = [Uᵀx; Wᵀx].

    ``out`` (shaped like X) and ``scratch`` (1-D, at least
    :func:`symv_scratch_numel` elements; see :func:`symv_workspace`) are
    the workspace: given, the call allocates nothing and returns ``out``;
    left out, it allocates them.
    """
    w0 = _window_start("symv_lower", b, t0)
    m = b.shape[0]
    if x.ndim not in (1, 2) or x.shape[0] != m:
        raise ValueError(f"symv_lower: X{tuple(x.shape)} does not fit "
                         f"B{tuple(b.shape)}")
    nc = 1 if x.ndim == 1 else x.shape[1]
    if not 1 <= nc <= SYMV_MAX_NC:
        raise ValueError(f"symv_lower: takes 1 to {SYMV_MAX_NC} vectors, "
                         f"got {nc}")
    if b.device != x.device:
        raise ValueError("symv_lower: operands on different devices")
    if b.dtype != x.dtype:
        raise TypeError("symv_lower: operands of different dtypes")
    half = 0
    if panel is not None:
        if x.ndim != 1:
            raise ValueError("symv_lower: a panel takes one vector X")
        if (panel.ndim != 2 or panel.shape[0] != m
                or panel.shape[1] % 2):
            raise ValueError(f"symv_lower: panel{tuple(panel.shape)} is not "
                             f"an (m, 2h) buffer [U | W] for m = {m}")
        half = panel.shape[1] // 2
        nb = half if nb is None else nb
        if not 0 <= nb <= half:
            raise ValueError(f"symv_lower: nb = {nb} outside 0..{half}")
        if panel.device != b.device or panel.dtype != b.dtype:
            raise TypeError("symv_lower: the panel's dtype or device is not "
                            "B's")
    _check_symv_workspace(b, x, panel, out, scratch)
    if b.device.type == "cpu":
        q = _symv_lower_ref(b, x, t0, panel, nb)
        return q if out is None else out.copy_(q)
    _check_kernel_dtype("symv_lower", b)
    ldb = _ld(b, "B", "symv_lower")
    ldx = x.stride(0) if x.ndim == 1 else _ld(x, "X", "symv_lower")
    if ldx < 1:
        raise ValueError(f"symv_lower: X needs a positive row stride, got "
                         f"strides {tuple(x.stride())}")
    ldp = 0 if panel is None else _ld(panel, "panel", "symv_lower")
    need = symv_scratch_numel(m, t0, nc, 2 * half)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if scratch is None:
        # g, then partial sums, one slot per (source tile, vector, window
        # row): each is written by exactly one block and summed in a fixed
        # order by the second pass.  A buffer made here goes back to
        # PyTorch's caching allocator when this function returns; whoever
        # gets it next on this stream runs after the two passes.
        scratch = torch.empty((need,), dtype=x.dtype, device=x.device)
    elif scratch.numel() < need:
        raise ValueError(f"symv_lower: scratch holds {scratch.numel()} "
                         f"elements, the call needs {need}")
    fn = getattr(load_library(), "eigenexa_symv_lower_" + _SUFFIX[b.dtype])
    if panel is not None:
        # g = [Uᵀx; Wᵀx] over the window, at the front of the scratch
        torch.mv(panel[w0:].T, x[w0:], out=scratch[:2 * half])
    args = (m, w0, nc, b.data_ptr(), ldb, x.data_ptr(), ldx, out.data_ptr(),
            nc, scratch.data_ptr(), scratch.numel(),
            None if panel is None else panel.data_ptr(), ldp, half,
            0 if panel is None else nb)
    # the entry point launches on the current device; the device guard is
    # entered only where B's card is not current already
    if b.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(b.device).cuda_stream)
    else:
        with torch.cuda.device(b.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "symv_lower")
    LAUNCHES["symv_lower"] += 1
    return out


def _rank2k_window_ref(b, u, w, t0: int = 0):
    """Plain PyTorch version of :func:`rank2k_update_window`: the two
    rank-nb products on the window's view, in place."""
    w0 = t0 * WIN_TM
    win = b[w0:, w0:]
    win.addmm_(u[w0:], w[w0:].T, alpha=-1)
    win.addmm_(w[w0:], u[w0:].T, alpha=-1)
    return b


def rank2k_update_window(b, u, w, t0: int = 0):
    """``B[w0:, w0:] −= U[w0:]·W[w0:]ᵀ + W[w0:]·U[w0:]ᵀ`` in place, with
    w0 = t0·TM (TM = ``WIN_TM``): the windowed twin of
    :func:`rank2k_update`.  Real only.

    B: (m, m); U, W: (m, nb).  The whole window square is written;
    everything outside it is left as it was.  Returns B.
    """
    w0 = _window_start("rank2k_update_window", b, t0)
    m = b.shape[0]
    if u.ndim != 2 or u.shape != w.shape or u.shape[0] != m:
        raise ValueError(f"rank2k_update_window: U{tuple(u.shape)} "
                         f"W{tuple(w.shape)} do not fit B{tuple(b.shape)}")
    if len({t.device for t in (b, u, w)}) != 1:
        raise ValueError("rank2k_update_window: operands on different "
                         "devices")
    if len({t.dtype for t in (b, u, w)}) != 1:
        raise TypeError("rank2k_update_window: operands of different dtypes")
    if b.device.type == "cpu":
        return _rank2k_window_ref(b, u, w, t0)
    _check_kernel_dtype("rank2k_update_window", b)
    if _same_storage(b, u) or _same_storage(b, w):
        raise ValueError("rank2k_update_window: B must not share storage "
                         "with U or W")
    ldb = _ld(b, "B", "rank2k_update_window")
    p = torch.cat([u, w], dim=1)
    q = torch.cat([w, u], dim=1)
    fn = getattr(load_library(),
                 "eigenexa_sub_matmul_window_" + _SUFFIX[b.dtype])
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m, w0, p.shape[1], b.data_ptr(), ldb, p.data_ptr(),
                 p.stride(0), q.data_ptr(), q.stride(0), stream)
    _raise_on(err, "rank2k_update_window")
    LAUNCHES["rank2k_update_window"] += 1
    return b


# ---------------------------------------------------------------------------
# Sturm bisection (modes N and X): f64 whatever the solve's dtype
# ---------------------------------------------------------------------------

def sturm_setup(d, e1, e2=None):
    """The recurrence's operands as the kernel reads them, in f64, with the
    JAX package's pivmin guards (``eigenexa_tpu/ops/sturm.py:40,126``).

    Band 1 (``e2`` None): ``(d, e²)`` with a leading zero on e², and
    ``head = [pivmin]``, pivmin = 1e-30·max(max e², 1).  Band 2: ``(d
    shifted by two, e1 shifted by one, e2)``, each zero past its end, and
    ``head = [pivmin, d₀, d₁, e1₀]`` (d₁ = e1₀ = 0 past n), pivmin =
    1e-28·((max(max|d|, 1) + max|e1|) + max|e2|).  Shared by the kernel and
    its plain version, so the two see the same operands."""
    d = d.to(F64)
    e1 = e1.to(F64)
    n = d.shape[0]
    z = d.new_zeros
    if e2 is None:
        e_sq = torch.cat([z(1), e1 * e1])
        pivmin = torch.clamp_min(e_sq.amax(), 1.0) * 1e-30
        return (d.contiguous(), e_sq), pivmin.reshape(1)
    e2 = e2.to(F64)
    e1p = torch.cat([e1, z(n - e1.shape[0])])
    e2p = torch.cat([e2, z(n - e2.shape[0])])
    scale = (torch.clamp_min(d.abs().amax(), 1.0) + e1p.abs().amax()
             + e2p.abs().amax())
    d1 = d[1:2] if n > 1 else z(1)
    head = torch.cat([(scale * 1e-28).reshape(1), d[:1], d1, e1p[:1]])
    return (torch.cat([d[2:], z(min(n, 2))]), torch.cat([e1p[1:], z(1)]),
            e2p), head


def _sturm_count_ref(bands, head, x):
    """Plain version of the kernel's count: eigenvalues below each probe
    of ``x`` (k,), one step of the recurrence at a time over (k,) vectors,
    each operation rounded once, in the kernel's order.  int32 (k,)."""
    pivmin = head[0]
    neg_pivmin = -pivmin
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    if len(bands) == 2:
        q = torch.ones_like(x)
        for d_k, e_sq_k in zip(bands[0].unbind(), bands[1].unbind()):
            q = (d_k - x) - e_sq_k / q
            q = torch.where(q.abs() < pivmin, neg_pivmin, q)
            count += q < 0
        return count
    n = bands[0].shape[0]
    a = head[1] - x
    b = head[3].expand(x.shape)
    c = head[2] - x if n > 1 else torch.zeros_like(x)
    for d_next, e1_next, e2_k in zip(*(t.unbind() for t in bands)):
        piv = torch.where(a.abs() < pivmin,
                          torch.where(a >= 0, pivmin, neg_pivmin), a)
        count += piv < 0
        l1 = b / piv
        l2 = e2_k / piv
        a = c - l1 * b
        b = e1_next - l1 * e2_k
        c = (d_next - x) - l2 * e2_k
    return count


def _sturm_bisect_ref(d, e1, e2, a0, b0, n_iter: int,
                      check_valid: bool = False, w0=None, idx=None):
    """Plain PyTorch version of :func:`sturm_bisect`.  ``idx`` (plain
    version only) picks the eigenvalue indices to compute; each index's
    bracket evolves alone, so a subset gives the same bits as the whole."""
    bands, head = sturm_setup(d, e1, e2)
    n = bands[0].shape[0]
    ids = (torch.arange(n, device=bands[0].device) if idx is None
           else torch.as_tensor(idx, device=bands[0].device))
    a = a0.to(F64)[ids]
    b = b0.to(F64)[ids]
    if check_valid:
        valid = ((_sturm_count_ref(bands, head, a) <= ids)
                 & (_sturm_count_ref(bands, head, b) > ids))
    for _ in range(n_iter):
        mid = 0.5 * (a + b)
        above = _sturm_count_ref(bands, head, mid) > ids
        b = torch.where(above, mid, b)
        a = torch.where(above, a, mid)
    w = 0.5 * (a + b)
    if check_valid:
        w = torch.where(valid, w, w0.to(F64)[ids])
    return w


def sturm_bisect(d, e1, e2, a0, b0, n_iter: int, check_valid: bool = False,
                 w0=None):
    """Eigenvalue i of the symmetric tridiagonal T(d, e1) (``e2`` None) or
    pentadiagonal T(d, e1, e2), for every i, by ``n_iter`` halvings of the
    bracket [a0[i], b0[i]] (reference: src/bisect.F:67, src/bisect2.F:71):
    each step probes the midpoint with one Sturm count and keeps the half
    that holds index i.  With ``check_valid`` an index whose bracket does
    not hold it at the start returns ``w0[i]`` (the refinement's mask).

    d: (n,); e1: (n-1,); e2: (n-2,) or None; a0, b0, w0: (n,).  Returns f64
    (n,).  A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/sturm.cu`` (bit for bit the plain version's result) or raises.
    """
    n = d.shape[0]
    if d.ndim != 1 or e1.shape != (max(n - 1, 0),) or (
            e2 is not None and e2.shape != (max(n - 2, 0),)):
        raise ValueError(f"sturm_bisect: bands d{tuple(d.shape)} "
                         f"e1{tuple(e1.shape)} e2"
                         f"{None if e2 is None else tuple(e2.shape)} do not "
                         "fit (n,), (n-1,), (n-2,)")
    if check_valid and w0 is None:
        raise ValueError("sturm_bisect: check_valid needs w0")
    ends = (a0, b0) + ((w0,) if check_valid else ())
    if any(t.shape != (n,) for t in ends):
        raise ValueError(f"sturm_bisect: a0, b0 (and w0) must be ({n},)")
    tensors = (d, e1) + ((e2,) if e2 is not None else ()) + ends
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sturm_bisect: operands on different devices")
    if any(t.is_complex() for t in tensors):
        raise TypeError("sturm_bisect: the bands and brackets are real")
    if n_iter < 0:
        raise ValueError(f"sturm_bisect: n_iter = {n_iter} < 0")
    if d.device.type == "cpu":
        return _sturm_bisect_ref(d, e1, e2, a0, b0, n_iter, check_valid, w0)
    if d.device.type != "cuda":
        raise NotImplementedError(
            f"sturm_bisect: no kernel for device {d.device.type!r}")
    bands, head = sturm_setup(d, e1, e2)
    s2 = bands[2] if e2 is not None else None
    a0, b0 = a0.to(F64).contiguous(), b0.to(F64).contiguous()
    w0 = w0.to(F64).contiguous() if check_valid else None
    w = torch.empty((n,), dtype=F64, device=d.device)
    fn = load_library().eigenexa_sturm_bisect_f64
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(n, 1 if e2 is None else 2, bands[0].data_ptr(),
                 bands[1].data_ptr(), None if s2 is None else s2.data_ptr(),
                 head.data_ptr(), a0.data_ptr(), b0.data_ptr(),
                 None if w0 is None else w0.data_ptr(), n_iter, w.data_ptr(),
                 stream)
    _raise_on(err, "sturm_bisect")
    LAUNCHES["sturm_bisect"] += 1
    return w
