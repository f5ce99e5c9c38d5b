"""The port's hand-written CUDA kernels and its solves on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where only PyTorch is installed; the
repository's conftest imports JAX, so switch it off there:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Kernel tolerance: max abs error ≤ c·(max|B| + k·max|P|·max|Q|), c = 1e-5
in f32 and 1e-13 in f64 — the kernel and its plain version differ only in
summation order; in c64 and c128 the same c over the 2k real terms of a
complex dot, with moduli.  For ``symv_lower`` the bound is
c·√m·max|B|·max|X|: a sum of m products whose rounding grows like √m, far
below the O(1) error of a tile dropped or counted twice; with a panel it
adds c·2nb·max|P|·max|g| for the corrections' dots.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402
from eigenexa_tpu_torch.testing import (frank, orthogonality_check,  # noqa: E402
                                        residual_check)

pytestmark = pytest.mark.gpu
ERR_C = {torch.float32: 1e-5, torch.float64: 1e-13,
         torch.complex64: 1e-5, torch.complex128: 1e-13}
DTYPES = [torch.float32, torch.float64]
CDTYPES = [torch.complex64, torch.complex128]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _randn(seed, *shape, dtype, device):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape)
    if dtype.is_complex:
        x = x + 1j * r.standard_normal(shape)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _bound(b, p, q):
    terms = p.shape[1] * (2 if b.is_complex() else 1)
    return ERR_C[b.dtype] * (float(b.abs().max()) + terms
                             * float(p.abs().max() * q.abs().max()))


# label: (m, n, k, view).  view None: B contiguous, a fresh output.  view
# (roff, coff, pad, kpad): B is buf[roff:, coff:coff + n] of an (roff + m,
# coff + n + pad) buffer, updated in place; P and Q are the first k columns
# of buffers k + kpad wide.  From "wide_view" on, the f32 launches are large
# enough for the 128-tile kernel: a last column quad that straddles n, a
# leading dimension that allows no 16-byte access, k below one K-slice, k one
# quad past a slice, k that ends inside a quad of a 16-byte-aligned row, and a
# square on either side of the launch rule (one tile for each of 132 SMs).
KERNEL_CASES = {
    "ragged": (1000, 777, 100, None),
    "small_view": (283, 251, 37, (17, 9, 0, 0)),
    "wide_view": (4200, 4097, 128, (0, 0, 103, 0)),
    "odd_ld_view": (4200, 4097, 128, (0, 0, 104, 0)),
    "offset_view": (4100, 4100, 128, (37, 37, 0, 0)),
    "k5": (4224, 4224, 5, None),
    "k132": (4224, 4224, 132, None),
    "k130_of_132": (4224, 4224, 130, (0, 0, 0, 2)),
    "under_rule": (1408, 1408, 128, None),
    "over_rule": (1409, 1409, 128, None),
}


@pytest.mark.parametrize("dtype", DTYPES + CDTYPES)
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_matches_plain(cuda, dtype, case):
    """A fresh output, or in place on a strided view with everything
    outside the view left as it was; the launch counter rises once."""
    m, n, k, view = KERNEL_CASES[case]
    roff, coff, pad, kpad = view or (0, 0, 0, 0)
    buf, pbuf, qbuf = (_randn(s, *sh, dtype=dtype, device=cuda)
                       for s, sh in ((1, (roff + m, coff + n + pad)),
                                     (2, (m, k + kpad)), (3, (n, k + kpad))))
    b, p, q = buf[roff:, coff:coff + n], pbuf[:, :k], qbuf[:, :k]
    keep = buf.clone()
    ref = tk._sub_matmul_ref(b, p, q)
    before = tk.LAUNCHES["sub_matmul"]
    if view is None:
        out = tk.sub_matmul(b, p, q)
        assert out.data_ptr() != b.data_ptr()
    else:
        out = tk.sub_matmul(b, p, q, out=b)
        assert out.data_ptr() == b.data_ptr()
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sub_matmul"] == before + 1
    assert float((out - ref).abs().max()) <= _bound(
        keep[roff:, coff:coff + n], p, q)
    outside = torch.ones_like(buf, dtype=torch.bool)
    if view is not None:
        outside[roff:, coff:coff + n] = False
        assert not torch.equal(buf, keep)
    assert torch.equal(buf[outside], keep[outside])


@pytest.mark.parametrize("m,n", [(300, 200), (4224, 4224)])
def test_kernel_with_k_zero_writes_b(cuda, m, n):
    """k = 0: no product, OUT = B, through either kernel of the launch
    rule."""
    b = _randn(1, m, n, dtype=torch.float32, device=cuda)
    p, q = (torch.empty(r, 0, dtype=torch.float32, device=cuda)
            for r in (m, n))
    out = tk.sub_matmul(b, p, q)
    torch.cuda.synchronize()
    assert out.data_ptr() != b.data_ptr() and torch.equal(out, b)


@pytest.mark.parametrize("dtype", DTYPES + CDTYPES)
@pytest.mark.parametrize("m,n,k,ld", [(4224, 4224, 128, 4224),
                                      (4200, 4097, 100, 4201)])
def test_large_call_and_row_blocks_give_the_same_bits(cuda, m, n, k, ld,
                                                      dtype):
    """The launch rule sends a large f32 call to the 128-tile kernel and
    each block of 384 rows of the same product (3 x 33 tiles, under one
    for each SM) to the 64-tile kernel.  Both sum over k in one order with
    fma, so the results are bitwise equal, whichever kernel ran.  In f64
    both take the DMMA kernel, whose sums do not depend on where a tile
    lies: bitwise equal too; in c64 and c128 one kernel each, likewise."""
    b = _randn(1, m, ld, dtype=dtype, device=cuda)[:, :n]
    p, q = (_randn(s, r, k, dtype=dtype, device=cuda)
            for s, r in ((2, m), (3, n)))
    whole = tk.sub_matmul(b, p, q)
    blocks = torch.empty_like(whole)
    for r0 in range(0, m, 384):
        tk.sub_matmul(b[r0:r0 + 384], p[r0:r0 + 384], q,
                      out=blocks[r0:r0 + 384])
    torch.cuda.synchronize()
    assert float((whole - tk._sub_matmul_ref(b, p, q)).abs().max()) <= _bound(
        b, p, q)
    assert torch.equal(whole, blocks)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    before = tk.LAUNCHES["sub_matmul"]
    b, p, q = (_randn(s, *sh, dtype=torch.float32, device=cuda)
               for s, sh in ((1, (64, 64)), (2, (64, 8)), (3, (64, 8))))
    # complex launches (test_kernel_matches_plain); a lazy conjugate, which
    # is not in the stored values the kernel reads, is refused
    bc, pc, qc = (x.to(torch.complex64) for x in (b, p, q))
    with pytest.raises(ValueError, match="lazy conjugate"):
        tk.sub_matmul(bc, pc, qc.conj())
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,t0,off", [(1837, 1, 0), (1024, 0, 0),
                                      (1300, 2, 0), (1200, 1, 5),
                                      (515, 1, 0)])
def test_fused_symv_lower_matches_plain(cuda, dtype, m, t0, off):
    """The form the windowed column calls: one vector and a panel [U | W]
    of 64 columns a half, 63 filled, zero above the window, held against
    the plain version (the symv, then ``q - U (Wᵀx) - W (Uᵀx)``) at the
    ragged, offset and late-window cases above.  A workspace sized for
    the whole matrix and filled with NaN, reused twice, gives the bits of
    a call that makes its own."""
    nb, half = 63, 64
    big = _dirty_symmetric(51, m + off, dtype, cuda)
    b = big[off:, off:]
    x = _randn(53, m, dtype=dtype, device=cuda)
    w0 = t0 * tk.WIN_TM
    # a view one column into its buffer: no 16-byte-aligned rows
    panel = _randn(54, m, 2 * half + 3, dtype=dtype, device=cuda)[:, 1:-2]
    panel[:w0] = 0
    panel[:, nb] = float("nan")                 # unfilled: never read
    panel[:, half + nb] = float("nan")
    kw = {"panel": panel, "nb": nb}
    ws = tk.symv_workspace(b, panel_cols=2 * half)
    ws["out"].fill_(float("nan"))
    ws["scratch"].fill_(float("nan"))
    before = tk.LAUNCHES["symv_lower"]
    fresh = tk.symv_lower(b, x, t0=t0, **kw)
    reused = tk.symv_lower(b, x, t0=t0, **kw, **ws)
    again = tk.symv_lower(b, x, t0=t0, **kw, **ws).clone()
    torch.cuda.synchronize()
    assert tk.LAUNCHES["symv_lower"] == before + 3
    assert reused is ws["out"]
    ref = tk._symv_lower_ref(b, x, t0, **kw)
    u, w = panel[w0:, :nb], panel[w0:, half:half + nb]
    g = torch.cat([u.T @ x[w0:], w.T @ x[w0:]])
    bound = ERR_C[dtype] * (m ** 0.5 * float(torch.tril(b).abs().max()
                                             * x.abs().max())
                            + 2 * nb * float(torch.cat([u, w]).abs().max()
                                             * g.abs().max()))
    assert float((fresh - ref).abs().max()) <= bound
    assert not bool(fresh[:w0].any())
    assert torch.equal(fresh, again) and torch.equal(reused, again)


def test_symv_lower_refuses_a_short_scratch(cuda):
    b = _dirty_symmetric(61, 700, torch.float32, cuda)
    x = _randn(62, 700, dtype=torch.float32, device=cuda)
    need = tk.symv_scratch_numel(700, 0, 1)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="scratch holds"):
        tk.symv_lower(b, x, scratch=torch.empty(need - 1, device=cuda))
    # a smaller window needs less: the first window's buffer serves it
    assert tk.symv_scratch_numel(700, 1, 1) < need
    assert tk.LAUNCHES == before


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
                                         (1100, 2, 64, 0), (1000, 1, 20, 9),
                                         (4500, 1, 64, 0), (4501, 1, 64, 0)])
def test_rank2k_update_window_matches_plain(cuda, dtype, m, t0, nb, off):
    """The last two windows are large enough for the f32 128-tile kernel;
    their edge is no multiple of its tile, and m = 4501 leaves no 16-byte
    access to B."""
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
    with pytest.raises(NotImplementedError, match="real only"):
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
    with pytest.raises(NotImplementedError, match="real only"):
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
                               "rank2k_update_window": 20, "sub_matmul": 11,
                               "sturm_bisect": 0}
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


def test_windowed_eigen_s_f64_on_the_card(cuda):
    """Frank n=1100 f64 through the windowed reduction: 17 full panels
    (1088 symv_lower, 17 rank2k_update_window launches; the window reaches
    t0 = 2), 9 WY blocks; every f64 launch of the three kernels on one
    solve.  Checks pass and a rerun is bitwise equal."""
    from eigenexa_tpu_torch.ops import householder
    from eigenexa_tpu_torch.testing import eigenvalue_check, frank_spectrum

    n = 1100
    ctx = ext.eigen_init(cuda)
    a = frank(n, torch.float64, cuda)
    old = householder.TRD_IMPL
    householder.TRD_IMPL = "windowed"
    try:
        for key in tk.LAUNCHES:
            tk.LAUNCHES[key] = 0
        w, z, _ = ext.eigen_s(a, ctx=ctx)
        assert tk.LAUNCHES == {"symv_lower": 1088,
                               "rank2k_update_window": 17, "sub_matmul": 9,
                               "sturm_bisect": 0}
        w2, z2, _ = ext.eigen_s(a, ctx=ctx)
    finally:
        householder.TRD_IMPL = old
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    wt = eigenvalue_check(w, frank_spectrum(n, torch.float64, cuda))
    assert wt.passed or wt.caution, wt
    assert torch.equal(w, w2) and torch.equal(z, z2)
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


@pytest.mark.parametrize("dtype", CDTYPES)
def test_eigen_h_on_the_card(cuda, dtype):
    """The phased Frank matrix at n = 300, c64 and c128: 4 TRD panels with a
    trailing block and 3 WY blocks launch the complex kernel 7 times; the
    solve passes the checks, repeats bitwise, and agrees with the CPU solve
    (plain versions) to 1e-12·‖A‖ in c128 and 1e-4·‖A‖ in c64."""
    from eigenexa_tpu_torch.testing import frank_hermitian

    ctx = ext.eigen_init(cuda)
    a = frank_hermitian(300, dtype, device=cuda)
    before = tk.LAUNCHES["sub_matmul"]
    w, z, _ = ext.eigen_h(a, ctx=ctx)
    assert tk.LAUNCHES["sub_matmul"] == before + 7
    assert z.device.type == "cuda" and z.dtype == dtype
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    w2, z2, _ = ext.eigen_h(a, ctx=ctx)
    assert torch.equal(w, w2) and torch.equal(z, z2)
    wc, _, _ = ext.eigen_h(a.cpu(), ctx=ext.eigen_init("cpu"))
    tol = 1e-12 if dtype == torch.complex128 else 1e-4
    assert float((w.cpu() - wc).abs().max()) < tol * float(wc.abs().max())
    ext.eigen_free()


def test_eigen_h_modes_on_the_card(cuda):
    """Modes N, X, T, S and C at c128 n = 200 on the card: the launches of
    their stages (3 TRD panels, 2 WY blocks), values against mode A."""
    from eigenexa_tpu_torch.testing import frank_hermitian

    ctx = ext.eigen_init(cuda)
    a = frank_hermitian(200, torch.complex128, device=cuda)
    wa, za, _ = ext.eigen_h(a, ctx=ctx)
    scale = float(wa.abs().max())
    for mode, launches in (("N", 3), ("X", 5), ("T", 3), ("S", 5),
                           ("C", 3)):
        before = tk.LAUNCHES["sub_matmul"]
        w, z, _ = ext.eigen_h(a, mode=mode, ctx=ctx)
        assert tk.LAUNCHES["sub_matmul"] == before + launches, mode
        if mode in "NXT":
            assert float((w - wa).abs().max()) < 1e-12 * scale, mode
        if mode == "X":
            assert torch.equal(z, za)
        if mode in "TS":
            assert orthogonality_check(z).passed
    ext.eigen_free()


@pytest.mark.parametrize("dtype", DTYPES)
def test_eigen_gev_on_the_card(cuda, dtype):
    """A = Frank, B = designed(linspace(1, 2, n)) at n = 300: mode A runs
    two rolled eigen_s solves (2 × 7 launches), passes the GEV checks,
    repeats bitwise and agrees with the CPU; mode N launches sturm_bisect
    once."""
    from eigenexa_tpu_torch.testing import (b_orthogonality_check, designed,
                                            gev_residual_check)

    ctx = ext.eigen_init(cuda)
    a = frank(300, dtype, cuda)
    b = designed(torch.linspace(1.0, 2.0, 300), dtype=dtype, device=cuda)
    before = dict(tk.LAUNCHES)
    w, z, _ = ext.eigen_gev(a, b, ctx=ctx)
    assert tk.LAUNCHES["sub_matmul"] == before["sub_matmul"] + 14
    assert gev_residual_check(a, b, z, w).passed
    assert b_orthogonality_check(z, b).passed
    w2, z2, _ = ext.eigen_gev(a, b, ctx=ctx)
    assert torch.equal(w, w2) and torch.equal(z, z2)
    wc, _, _ = ext.eigen_gev(a.cpu(), b.cpu(), ctx=ext.eigen_init("cpu"))
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert float((w.cpu() - wc).abs().max()) < tol * float(wc.abs().max())
    before = tk.LAUNCHES["sturm_bisect"]
    wn, zn, _ = ext.eigen_gev(a, b, mode="N", ctx=ctx)
    assert zn is None and tk.LAUNCHES["sturm_bisect"] == before + 1
    assert float((wn - w).abs().max()) < tol * float(wc.abs().max())
    ext.eigen_free()


# ---------------------------------------------------------------------------
# the band-2 path and the Sturm kernel
# ---------------------------------------------------------------------------

def _bands(seed, n, band2, device):
    g = np.random.default_rng(seed)
    out = [g.standard_normal(n), g.standard_normal(max(n - 1, 0))]
    out.append(g.standard_normal(max(n - 2, 0)) if band2 else None)
    return [None if x is None else torch.as_tensor(x, device=device)
            for x in out]


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("band2", [False, True])
def test_sturm_bisect_gives_the_plain_versions_bits(cuda, band2, valid):
    """n = 1, 2, 31, 33, 700 and 1000 (none a multiple of a block's
    indices but 1 and 2; n = 700 and 1000 stage the bands in two chunks of
    512), each at n_iter = 1, 2, 7, 45 and 70 (most no multiple of the
    levels a round, so the last round is short): bisection from the
    Gershgorin brackets or, with the valid check, refinement around w0 with
    index n // 2 pushed off its bracket, which must keep its w0.  Every case
    bitwise equal to the plain version, which runs on copies on the CPU, on
    every index up to n = 33 and on 40 indices above (each index's bracket
    evolves alone).  The 70-step bisection agrees with the library's
    eigenvalues."""
    from eigenexa_tpu_torch.ops import sturm

    for n in (1, 2, 31, 33, 700, 1000):
        d, e1, e2 = _bands(71 + n, n, band2, cuda)
        host = [None if x is None else x.cpu() for x in (d, e1, e2)]
        w_bisect = tk.sturm_bisect(d, e1, e2,
                                   *sturm.bisect_brackets(d, e1, e2), 70)
        w0 = w_bisect + 1e-9
        w0[n // 2] += 100.0
        ends = (sturm.refine_brackets(w0) if valid
                else sturm.bisect_brackets(d, e1, e2))
        idx = (None if n <= 33
               else torch.linspace(0, n - 1, 40).round().long())
        for n_iter in (1, 2, 7, 45, 70):
            before = tk.LAUNCHES["sturm_bisect"]
            got = tk.sturm_bisect(d, e1, e2, *ends, n_iter, valid, w0)
            assert tk.LAUNCHES["sturm_bisect"] == before + 1
            torch.cuda.synchronize()
            want = tk._sturm_bisect_ref(*host, *(x.cpu() for x in ends),
                                        n_iter, valid, w0.cpu(), idx=idx)
            got = got.cpu()
            assert torch.equal(got if idx is None else got[idx], want), \
                (n, n_iter)
            if valid:
                assert float(got[n // 2]) == float(w0[n // 2])
        dense = torch.diag(d) + torch.diag(e1, 1) + torch.diag(e1, -1)
        if band2 and n > 2:
            dense += torch.diag(e2, 2) + torch.diag(e2, -2)
        assert float((w_bisect - torch.linalg.eigvalsh(dense)).abs().max()) \
            < 1e-12 * float(dense.abs().sum(1).max())


def test_sturm_bisect_raises_on_what_the_kernel_does_not_take(cuda):
    d, e1, _ = _bands(72, 20, False, cuda)
    ends = torch.zeros(20, device=cuda), torch.ones(20, device=cuda)
    with pytest.raises(TypeError, match="real"):
        tk.sturm_bisect(d.to(torch.complex128), e1, None, *ends, 4)
    with pytest.raises(ValueError, match="devices"):
        tk.sturm_bisect(d, e1.cpu(), None, *ends, 4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_symv_lower_pair_into_a_reused_workspace(cuda, dtype):
    """The band-2 pair pass: nc = 2 into one workspace of its window group,
    reused by calls with other vectors; each call gives the bits of a call
    that makes its own workspace, and the plain version's values."""
    m, t0 = 1300, 1
    b = _dirty_symmetric(73, m, dtype, cuda)
    ws = tk.symv_workspace(b, t0, nc=2)
    for seed in (74, 75):
        x = _randn(seed, m, 2, dtype=dtype, device=cuda)
        out = tk.symv_lower(b, x, t0=t0, **ws)
        assert out.data_ptr() == ws["out"].data_ptr()
        fresh = tk.symv_lower(b, x, t0=t0)
        assert torch.equal(out, fresh)
        ref = tk._symv_lower_ref(b, x, t0)
        w0 = t0 * tk.WIN_TM
        bound = ERR_C[dtype] * m ** 0.5 * float(
            torch.tril(b[w0:, w0:]).abs().max()) * float(x.abs().max())
        assert float((out - ref).abs().max()) <= bound


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["rolled", "windowed"])
def test_eigen_sx_on_the_card(cuda, impl, dtype):
    """Frank n = 512: 7 band-2 panels with a trailing update and 4 WY
    blocks; rolled, 11 sub_matmul launches; windowed, 224 symv_lower pair
    calls (nc = 2), 7 rank2k_update_window and 4 sub_matmul.  The checks
    pass, a rerun is bitwise equal, and the CPU solve agrees to
    1e-12·‖A‖ in f64, 1e-4·‖A‖ in f32."""
    from eigenexa_tpu_torch.ops import householder

    n = 512
    want = ({"sub_matmul": 11, "symv_lower": 0, "rank2k_update_window": 0}
            if impl == "rolled" else
            {"sub_matmul": 4, "symv_lower": 224, "rank2k_update_window": 7})
    ctx = ext.eigen_init(cuda)
    a = frank(n, dtype, cuda)
    old = householder.TRD_IMPL
    householder.TRD_IMPL = impl
    try:
        for key in tk.LAUNCHES:
            tk.LAUNCHES[key] = 0
        w, z, _ = ext.eigen_sx(a, ctx=ctx)
        assert tk.LAUNCHES == {**want, "sturm_bisect": 0}
        w2, z2, _ = ext.eigen_sx(a, ctx=ctx)
        wc, _, _ = ext.eigen_sx(a.cpu(), ctx=ext.eigen_init("cpu"))
    finally:
        householder.TRD_IMPL = old
    assert z.device.type == "cuda" and z.dtype == dtype
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed
    assert torch.equal(w, w2) and torch.equal(z, z2)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert float((w.cpu() - wc).abs().max()) < tol * float(wc.abs().max())
    ext.eigen_free()


@pytest.mark.parametrize("driver", ["eigen_s", "eigen_sx"])
def test_modes_n_x_and_r_on_the_card(cuda, driver):
    """Frank n = 300 f64: modes N and X launch sturm_bisect once each and
    agree with mode A and with the CPU solve; mode R on the reduction's
    bands launches nothing and gives the CPU's values."""
    from eigenexa_tpu_torch.ops import band, householder

    drive = getattr(ext, driver)
    ctx = ext.eigen_init(cuda)
    a = frank(300, torch.float64, cuda)
    wa, _, _ = drive(a, ctx=ctx)
    scale = float(wa.abs().max())
    for mode in "NX":
        before = tk.LAUNCHES["sturm_bisect"]
        w, z, _ = drive(a, mode=mode, ctx=ctx)
        assert tk.LAUNCHES["sturm_bisect"] == before + 1
        assert (z is None) == (mode == "N")
        assert float((w - wa).abs().max()) < 1e-12 * scale
        wc, _, _ = drive(a.cpu(), mode=mode, ctx=ext.eigen_init("cpu"))
        assert float((w.cpu() - wc).abs().max()) < 1e-12 * scale
    red = (householder.tridiagonalize(a) if driver == "eigen_s"
           else band.band2_reduce(a))
    bands = (red.d, red.e) if driver == "eigen_s" else (red.d, red.e1,
                                                        red.e2)
    before = dict(tk.LAUNCHES)
    w, z, _ = drive(None, mode="R", stage_data=bands, ctx=ctx)
    assert tk.LAUNCHES == before and w.device.type == "cuda"
    wc, _, _ = drive(None, mode="R", stage_data=[x.cpu() for x in bands])
    assert float((w.cpu() - wc).abs().max()) < 1e-12 * scale
    ext.eigen_free()


def test_a_cpu_call_counts_no_launch(cuda):
    """The same wrappers and drivers on CPU tensors take the plain
    versions, on a machine with a card too."""
    from eigenexa_tpu_torch.ops import sturm

    before = dict(tk.LAUNCHES)
    d, e1, e2 = _bands(76, 80, True, torch.device("cpu"))
    sturm.eigvals_bisect_band2(d, e1, e2)
    sturm.refine_eigenvalues(d, e1, d.sort().values)
    a = frank(100, torch.float64)
    ext.eigen_sx(a, mode="X", ctx=ext.eigen_init("cpu"))
    assert tk.LAUNCHES == before
    ext.eigen_free()


@pytest.mark.parametrize("band", [1, 2])
def test_chunked_level_on_the_card(cuda, band, monkeypatch):
    """Both D&C trees at n=2048 with their two top levels panel-chunked
    (the chunk width lowered to 1024, panels of 256) against the unchunked
    tree on the card: w within 1e-12 of ‖T‖, both pass the checks on T,
    and the chunked reruns are bitwise equal."""
    from eigenexa_tpu_torch.ops.band import assemble_band2
    from eigenexa_tpu_torch.solvers import dc_band, dc_tree

    n = 2048
    g = np.random.default_rng(80 + band)
    bands = [torch.as_tensor(g.standard_normal(n - k), device=cuda)
             for k in range(band + 1)]
    mod, solve = ((dc_tree, dc_tree.solve_tridiag_dc) if band == 1
                  else (dc_band, dc_band.solve_band2_dc))
    w0, _ = solve(*bands)
    monkeypatch.setattr(mod, "_LEVEL_CHUNK_MIN", 1024)
    monkeypatch.setattr(mod, "_LEVEL_CHUNK_PANEL", 256)
    w1, s1 = solve(*bands)
    w2, s2 = solve(*bands)
    assert torch.equal(w1, w2) and torch.equal(s1, s2)
    tt = assemble_band2(*bands, *([torch.zeros(n - 2, dtype=torch.float64,
                                               device=cuda)] * (band == 1)))
    scale = float(tt.abs().sum(dim=1).max())
    assert float((w1 - w0).abs().max()) < 1e-12 * scale
    assert residual_check(tt, s1, w1).passed
    assert orthogonality_check(s1).passed


def test_memory_rule_reads_the_cards_free_memory(cuda, monkeypatch):
    """"auto" reads torch.cuda.mem_get_info of the input's device: with
    nothing reported free it takes the windowed reduction (symv_lower
    launches), with the card's real free memory the rolled one."""
    from eigenexa_tpu_torch.ops import householder

    real = torch.cuda.mem_get_info
    asked = []

    def nothing_free(device=None):
        asked.append(device)
        return 0, real(device)[1]

    a = _randn(83, 4096, 4096, dtype=torch.float32, device=cuda)
    a = a + a.T
    torch.cuda.empty_cache()
    monkeypatch.setattr(torch.cuda, "mem_get_info", nothing_free)
    before = tk.LAUNCHES["symv_lower"]
    householder.tridiagonalize(a)
    assert asked == [a.device] and tk.LAUNCHES["symv_lower"] > before
    monkeypatch.setattr(torch.cuda, "mem_get_info", real)
    before = dict(tk.LAUNCHES)
    householder.tridiagonalize(a)
    assert tk.LAUNCHES["symv_lower"] == before["symv_lower"]
    assert tk.LAUNCHES["sub_matmul"] > before["sub_matmul"]
