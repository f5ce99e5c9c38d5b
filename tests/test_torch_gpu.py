"""The port's hand-written CUDA kernel and its solve on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where only PyTorch is installed; the
repository's conftest imports JAX, so switch it off there:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Kernel tolerance: max abs error ≤ c·(max|B| + k·max|P|·max|Q|), c = 1e-5
in f32 and 1e-13 in f64 — the kernel and its plain version differ only in
summation order.
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
