"""Fused subtract-matmul ``OUT = B − P·Qᴴ``: the port's kernel wrappers.

Counterpart of ``eigenexa_tpu/ops/pallas_kernels.py`` (``sub_matmul``,
``rank2k_update``, ``wy_apply``).  The kernel is hand-written CUDA for
Hopper (``csrc/sub_matmul.cu``), built by ``ops/_build.py``.

Dispatch is by device, never by a fallback:

* a CPU tensor takes the plain version ``_sub_matmul_ref`` (the parity
  tests and the CPU solver run it);
* a CUDA tensor launches the kernel, or raises on what the kernel does not
  take (complex, other dtypes, non-unit column stride, bad aliasing).

``LAUNCHES`` counts kernel launches (the main path's proof that it ran
through the kernel); the plain version never touches it.
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops._build import load_library

LAUNCHES = {"sub_matmul": 0}

_FN = {torch.float32: "eigenexa_sub_matmul_f32",
       torch.float64: "eigenexa_sub_matmul_f64"}


def _sub_matmul_ref(b, p, q):
    """Plain PyTorch version, with the complex conj semantics of the JAX
    fallback (``b - p @ jnp.conj(q).T``)."""
    return b - p @ q.conj().T


def _ld(x: torch.Tensor, name: str) -> int:
    """Leading dimension of a row-major (unit column stride) 2-D view."""
    rows, cols = x.shape
    if cols > 1 and x.stride(1) != 1:
        raise ValueError(f"sub_matmul: {name} needs unit column stride, "
                         f"got strides {tuple(x.stride())}")
    if rows <= 1:
        return max(cols, 1)
    if x.stride(0) < cols:
        raise ValueError(f"sub_matmul: {name} rows overlap "
                         f"(strides {tuple(x.stride())}, shape {tuple(x.shape)})")
    return x.stride(0)


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

    B: (m, n); P: (m, k); Q: (n, k).  ``out`` may be B itself (the in-place
    trailing update); otherwise a new (m, n) tensor is returned.
    """
    _check(b, p, q, out)
    if b.device.type == "cpu":
        r = _sub_matmul_ref(b, p, q)
        if out is None:
            return r
        return out.copy_(r)
    if b.device.type != "cuda":
        raise NotImplementedError(
            f"sub_matmul: no kernel for device {b.device.type!r}")
    if b.is_complex():
        raise NotImplementedError(
            "sub_matmul: complex on CUDA is the Hermitian path (ROADMAP A13)")
    if b.dtype not in _FN:
        raise TypeError(f"sub_matmul: no kernel for dtype {b.dtype}")
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
    ldb, ldp, ldq, ldo = (_ld(b, "B"), _ld(p, "P"), _ld(q, "Q"),
                          _ld(out, "out"))
    fn = getattr(load_library(), _FN[b.dtype])
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m, n, p.shape[1], b.data_ptr(), ldb, p.data_ptr(), ldp,
                 q.data_ptr(), ldq, out.data_ptr(), ldo, stream)
    if err != 0:
        raise RuntimeError(f"sub_matmul kernel launch failed: CUDA error "
                           f"{err}")
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
