"""The port's kernel wrappers: ``sub_matmul``, ``symv_lower``,
``rank2k_update_window`` and ``sturm_bisect``.

Counterpart of ``eigenexa_tpu/ops/pallas_kernels.py``.  Each kernel is
hand-written CUDA for Hopper under ``csrc/`` (``sub_matmul.cu``,
``symv_lower.cu``, ``sturm.cu``), built by ``ops/_build.py``:

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
  PyTorch on the card could only issue launch by launch.

``WIN_TM`` is the window granularity TM: a window starts at row and column
``t0·TM``.  It says nothing about the kernels' own tiles, and a matrix edge
need not be a multiple of it.

Dispatch is by device, never by a fallback:

* a CPU tensor takes the plain version (``_sub_matmul_ref``,
  ``_symv_lower_ref``, ``_rank2k_window_ref``, ``_sturm_bisect_ref``); the
  parity tests and the CPU solver run it;
* a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (other dtypes, complex but for ``sub_matmul``, non-unit column
  stride, bad aliasing, more than ``SYMV_MAX_NC`` vectors, a window that
  starts past the matrix).

``sub_matmul`` takes f32, f64, c64 and c128 (``rank2k_update`` and
``wy_apply`` with it: their formulas carry the conjugates).  The windowed
kernels are real only, as the JAX package's windowed path is: a Hermitian
reduction is always rolled.

``LAUNCHES`` counts wrapper calls that launched their kernel (the main
path's proof that it ran through the kernels); a plain version never
touches it.
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops._build import load_library

LAUNCHES = {"sub_matmul": 0, "symv_lower": 0, "rank2k_update_window": 0,
            "sturm_bisect": 0}

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
    return sub_matmul(z, v, y.conj().T.contiguous(), out=out)


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
