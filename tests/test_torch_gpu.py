"""The port's hand-written CUDA kernels and its solves on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where only PyTorch is installed; the
repository's conftest imports JAX, so switch it off there:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Kernel tolerance: max abs error ≤ c·(max|B| + k·max|P|·max|Q|), c = 1e-5
in f32 and 1e-13 in f64 — the kernel and its plain version differ only in
summation order.  For ``symv_lower`` the bound is c·√m·max|B|·max|X|: a sum
of m products whose rounding grows like √m, far below the O(1) error of a
tile dropped or counted twice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402
from eigenexa_tpu_torch.testing import (frank, orthogonality_check,  # noqa: E402
                                        residual_check)

pytestmark = pytest.mark.gpu
ERR_C = {torch.float32: 1e-5, torch.float64: 1e-13}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _randn(seed, *shape, dtype, device):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _bound(b, p, q):
    return ERR_C[b.dtype] * (float(b.abs().max()) + p.shape[1]
                             * float(p.abs().max() * q.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain(cuda, dtype):
    """A fresh output at a ragged shape, then in place on a strided view;
    the launch counter rises once per call."""
    b, p, q = (_randn(s, *sh, dtype=dtype, device=cuda)
               for s, sh in ((1, (1000, 777)), (2, (1000, 100)),
                             (3, (777, 100))))
    before = tk.LAUNCHES["sub_matmul"]
    out = tk.sub_matmul(b, p, q)
    ref = tk._sub_matmul_ref(b, p, q)
    assert float((out - ref).abs().max()) <= _bound(b, p, q)

    big, p, q = (_randn(s, *sh, dtype=dtype, device=cuda)
                 for s, sh in ((5, (300, 260)), (6, (283, 37)),
                               (7, (251, 37))))
    keep = big.clone()
    view = big[17:, 9:]
    ref = tk._sub_matmul_ref(view, p, q)
    assert tk.sub_matmul(view, p, q, out=view).data_ptr() == view.data_ptr()
    assert tk.LAUNCHES["sub_matmul"] == before + 2
    assert float((view - ref).abs().max()) <= _bound(keep[17:, 9:], p, q)
    assert torch.equal(big[:17], keep[:17])
    assert torch.equal(big[:, :9], keep[:, :9])


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    before = tk.LAUNCHES["sub_matmul"]
    b, p, q = (_randn(s, *sh, dtype=torch.float32, device=cuda)
               for s, sh in ((1, (64, 64)), (2, (64, 8)), (3, (64, 8))))
    with pytest.raises(NotImplementedError, match="A13"):
        tk.sub_matmul(b.to(torch.complex64), p.to(torch.complex64),
                      q.to(torch.complex64))
    with pytest.raises(TypeError):
        tk.sub_matmul(b.half(), p.half(), q.half())
    with pytest.raises(ValueError, match="column stride"):
        tk.sub_matmul(b.T, p, q)
    big = _randn(4, 80, 80, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        tk.sub_matmul(big[:64, :64], p, q, out=big[1:65, :64])
    pq = _randn(5, 64, 16, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="storage"):
        tk.sub_matmul(b[:, :8], pq[:, :8], q[:8], out=pq[:, 8:])
    assert tk.LAUNCHES["sub_matmul"] == before


def _dirty_symmetric(seed, m, dtype, device):
    """Symmetric in its lower triangle; the upper triangle holds garbage
    that a kernel reading it would carry into the result."""
    a = _randn(seed, m, m, dtype=dtype, device=device)
    junk = _randn(seed + 1, m, m, dtype=dtype, device=device) * 1e6
    return torch.tril(a) + torch.triu(junk, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,t0,nc,off", [(1837, 1, 1, 0), (1024, 0, 2, 0),
                                         (1300, 2, 8, 0), (1200, 1, 1, 5),
                                         (515, 1, 3, 0)])
def test_symv_lower_matches_plain(cuda, dtype, m, t0, nc, off):
    """Ragged and whole-tile edges, 1 to 8 vectors, a window a few rows
    from the end, and a view that is not 16-byte aligned (off = 5)."""
    big = _dirty_symmetric(11, m + off, dtype, cuda)
    b = big[off:, off:]
    x = _randn(13, *((m,) if nc == 1 else (m, nc)), dtype=dtype, device=cuda)
    before = dict(tk.LAUNCHES)
    q = tk.symv_lower(b, x, t0=t0)
    q2 = tk.symv_lower(b, x, t0=t0)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["symv_lower"] == before["symv_lower"] + 2
    ref = tk._symv_lower_ref(b, x, t0)
    w0 = t0 * tk.WIN_TM
    bound = ERR_C[dtype] * m ** 0.5 * float(torch.tril(b).abs().max()
                                            * x.abs().max())
    assert q.shape == x.shape
    assert float((q - ref).abs().max()) <= bound
    assert not bool(q[:w0].any())              # zeros above the window
    assert torch.equal(q, q2)                  # fixed summation order


def test_symv_lower_takes_a_strided_vector(cuda):
    """A column of a panel buffer as X: row stride nb, not 1."""
    m = 700
    b = _dirty_symmetric(21, m, torch.float32, cuda)
    panel = _randn(23, m, 64, dtype=torch.float32, device=cuda)
    q = tk.symv_lower(b, panel[:, 7], t0=1)
    ref = tk._symv_lower_ref(b, panel[:, 7].contiguous(), 1)
    assert q.is_contiguous()
    assert float((q - ref).abs().max()) <= 1e-5 * m ** 0.5 * float(
        torch.tril(b).abs().max() * panel.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,t0,nb,off", [(1837, 1, 64, 0), (1024, 0, 64, 0),
                                         (1100, 2, 64, 0), (1000, 1, 20, 9)])
def test_rank2k_update_window_matches_plain(cuda, dtype, m, t0, nb, off):
    big = _randn(31, m + off, m + off, dtype=dtype, device=cuda)
    keep = big.clone()
    b = big[off:, off:]
    u, w = (_randn(s, m, nb, dtype=dtype, device=cuda) for s in (32, 33))
    ref = tk._rank2k_window_ref(b.clone(), u, w, t0)
    before = dict(tk.LAUNCHES)
    out = tk.rank2k_update_window(b, u, w, t0=t0)
    torch.cuda.synchronize()
    assert out is b
    assert tk.LAUNCHES["rank2k_update_window"] == (
        before["rank2k_update_window"] + 1)
    assert tk.LAUNCHES["sub_matmul"] == before["sub_matmul"]
    w0 = t0 * tk.WIN_TM
    bound = ERR_C[dtype] * (float(keep.abs().max())
                            + 2 * nb * float(u.abs().max() * w.abs().max()))
    assert float((b - ref).abs().max()) <= bound
    # outside the window nothing is written, bit for bit
    mask = torch.ones_like(big, dtype=torch.bool)
    mask[off + w0:, off + w0:] = False
    assert torch.equal(big[mask], keep[mask])
    assert not torch.equal(big[off + w0:, off + w0:],
                           keep[off + w0:, off + w0:])


def test_window_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    before = dict(tk.LAUNCHES)
    b = _randn(41, 600, 600, dtype=torch.float32, device=cuda)
    x = _randn(42, 600, 2, dtype=torch.float32, device=cuda)
    with pytest.raises(NotImplementedError, match="A13"):
        tk.symv_lower(b.to(torch.complex64), x.to(torch.complex64))
    with pytest.raises(TypeError):
        tk.symv_lower(b.half(), x.half())
    with pytest.raises(ValueError, match="column stride"):
        tk.symv_lower(b.T, x)
    with pytest.raises(ValueError, match="column stride"):
        tk.symv_lower(b, x.T.contiguous().T)
    with pytest.raises(ValueError, match="vectors"):
        tk.symv_lower(b, b[:, :9])
    with pytest.raises(ValueError, match="outside"):
        tk.symv_lower(b, x, t0=2)
    with pytest.raises(ValueError, match="different devices"):
        tk.symv_lower(b, x.cpu())
    with pytest.raises(NotImplementedError, match="A13"):
        tk.rank2k_update_window(b.to(torch.complex64),
                                x.to(torch.complex64),
                                x.to(torch.complex64))
    with pytest.raises(ValueError, match="storage"):
        tk.rank2k_update_window(b, b[:, :2], x)
    with pytest.raises(ValueError, match="column stride"):
        tk.rank2k_update_window(b.T, x, x.clone())
    assert tk.LAUNCHES == before


def test_windowed_eigen_s_on_the_card(cuda):
    """Frank n=1300 f32 through the windowed reduction: 20 full panels
    (1280 symv_lower, 20 rank2k_update_window launches; the window moves to
    t0 = 1 and 2), a 20-column remainder, 11 WY blocks through sub_matmul.
    n is no multiple of TM nor of the kernels' tiles."""
    from eigenexa_tpu_torch.ops import householder

    n = 1300
    ctx = ext.eigen_init(cuda)
    a = frank(n, torch.float32, cuda)
    old = householder.TRD_IMPL
    householder.TRD_IMPL = "windowed"
    try:
        for key in tk.LAUNCHES:
            tk.LAUNCHES[key] = 0
        w, z, _ = ext.eigen_s(a, ctx=ctx)
        assert tk.LAUNCHES == {"symv_lower": 1280,
                               "rank2k_update_window": 20, "sub_matmul": 11}
        w2, z2, _ = ext.eigen_s(a, ctx=ctx)
    finally:
        householder.TRD_IMPL = old
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    assert torch.equal(w, w2) and torch.equal(z, z2)
    wr, zr, _ = ext.eigen_s(a, ctx=ctx)          # the rolled path
    assert tk.LAUNCHES["symv_lower"] == 2 * 1280
    assert float((w - wr).abs().max()) < 1e-4 * float(wr.abs().max())
    ext.eigen_free()


@pytest.mark.parametrize("dtype", DTYPES)
def test_eigen_s_on_the_card(cuda, dtype):
    """Frank n=300: 4 TRD panels with a trailing block and 3 WY blocks
    launch the kernel 7 times; the solve passes the reference's checks,
    repeats bitwise, and agrees with the CPU solve (plain versions) to
    1e-12·‖A‖ in f64, 1e-4·‖A‖ in f32 (the f32 reductions round in
    another order)."""
    n = 300
    ctx = ext.eigen_init(cuda)
    a = frank(n, dtype, cuda)
    before = tk.LAUNCHES["sub_matmul"]
    w, z, _ = ext.eigen_s(a, ctx=ctx)
    assert tk.LAUNCHES["sub_matmul"] == before + 7
    assert w.device.type == "cuda" and z.dtype == dtype
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    w2, z2, _ = ext.eigen_s(a, ctx=ctx)
    assert torch.equal(w, w2) and torch.equal(z, z2)
    wc, _, _ = ext.eigen_s(a.cpu(), ctx=ext.eigen_init("cpu"))
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert float((w.cpu() - wc).abs().max()) < tol * float(wc.abs().max())
    ext.eigen_free()
