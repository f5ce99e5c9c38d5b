"""The port's panel-chunked top merges (ops/secular.rank1_merge_apply_parts,
solvers/dc_tree._merge_level_chunked, solvers/dc_band
._merge_level_band2_chunked), its memory rule (ops/householder
._needs_windowed) and the checks' column streaming (testing/checks.py,
``col_chunk``), on the CPU.

The chunk constants of both packages are lowered together, so that a tree
of n ≤ 300 takes its chunked levels (the JAX package's own tests lower its
constants the same way, tests/test_dc_tree.py and tests/test_band.py).
Tolerances: eigenvalues within 1e-13 absolute on standard-normal input
(the JAX package's own tolerance for its chunked trees); eigenvectors
through the projectors of each eigenvalue cluster within 1e-9; a chunked
merge against ``rank1_merge_core`` and the products within 1e-12 of the
operands' scale (only the shapes of the sums differ); the streamed checks
within 1e-12 relative of the unstreamed ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same_eigenspaces, n_, rng, t  # noqa: E402

from eigenexa_tpu.solvers import dc_band as jband  # noqa: E402
from eigenexa_tpu.solvers import dc_tree as jtree  # noqa: E402
from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.ops import secular as ts  # noqa: E402
from eigenexa_tpu_torch.solvers import dc_band as tband  # noqa: E402
from eigenexa_tpu_torch.solvers import dc_tree as ttree  # noqa: E402
from eigenexa_tpu_torch.testing import (orthogonality_check,  # noqa: E402
                                        residual_check)

N = 200          # leaf 32 pads to 256: levels 64, 128 and 256
CHUNK_MIN = 128  # the two top levels chunked
PANEL = 32


@pytest.fixture
def chunked(monkeypatch):
    """Both packages' chunk constants lowered; the JAX package's small
    levels no longer fused into one program (which would skip its
    chunked path)."""
    for mod in (jtree, jband, ttree, tband):
        monkeypatch.setattr(mod, "_LEVEL_CHUNK_MIN", CHUNK_MIN)
        monkeypatch.setattr(mod, "_LEVEL_CHUNK_PANEL", PANEL)
    monkeypatch.setattr(jtree, "_LEVEL_FUSE_MAX", 32)


def _bands(seed: int, band: int):
    g = rng(seed)
    return [g.standard_normal(N - k) for k in range(band + 1)]


def _scale(bands) -> float:
    return sum(float(np.abs(x).max()) for x in bands)


@pytest.mark.parametrize("band", [1, 2])
def test_chunked_tree_matches_jax_and_the_unchunked_tree(band, chunked,
                                                         monkeypatch):
    bands = _bands(60 + band, band)
    if band == 1:
        jw, js = jtree.solve_tridiag_dc(*map(jnp.asarray, bands),
                                        impl="level")
        solve = ttree.solve_tridiag_dc
    else:
        jw, js = jband.solve_band2_dc(*map(jnp.asarray, bands),
                                      impl="level")
        solve = tband.solve_band2_dc
    w, s = solve(*map(t, bands))
    w2, s2 = solve(*map(t, bands))
    assert torch.equal(w, w2) and torch.equal(s, s2)     # reruns bitwise
    gap = 1e-8 * _scale(bands)
    np.testing.assert_allclose(n_(w), n_(jw), atol=1e-13, rtol=0)
    assert_same_eigenspaces(s, js, w, tol=1e-9, gap=gap)
    mod = ttree if band == 1 else tband
    monkeypatch.setattr(mod, "_LEVEL_CHUNK_MIN", 16384)
    wu, su = solve(*map(t, bands))
    np.testing.assert_allclose(n_(w), n_(wu), atol=1e-13, rtol=0)
    assert_same_eigenspaces(s, su, w, tol=1e-9, gap=gap)
    assert orthogonality_check(s).passed


def test_chunked_levels_are_taken(chunked, monkeypatch):
    """The loop switches to the chunked level at CHUNK_MIN: 2 of the 3
    levels of N, in both trees."""
    seen = []
    for mod, name in ((ttree, "_merge_level_chunked"),
                      (tband, "_merge_level_band2_chunked")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, inner=inner, **k: (
            seen.append(a[0].shape[1]), inner(*a, **k))[1])
    ttree.solve_tridiag_dc(*map(t, _bands(62, 1)))
    tband.solve_band2_dc(*map(t, _bands(63, 2)))
    assert seen == [64, 128, 64, 128]                     # block size s


def _merge_input(bsz: int, m: int, seed: int):
    """Merges with a run of equal d, a run of three, and z's small enough
    to deflate."""
    g = rng(seed)
    d = g.standard_normal((bsz, m))
    d[:, 5:13] = 0.25
    d[:, 40:43] = d[:, 40:41]
    z = g.standard_normal((bsz, m))
    z[:, 20:23] = 1e-20
    return d, z, np.abs(g.standard_normal(bsz)) + 0.1


@pytest.mark.parametrize("m,panel", [(96, 64), (128, 32), (100, 1024)])
def test_merge_apply_parts_equals_core_and_products(m, panel):
    """(96, 64): the panel halves to 32, the JAX package's rule; (100,
    1024): one panel wider than m, which halves to 100 // 2**k = 25."""
    d, z, rho = _merge_input(2, m, 70 + m)
    core = ts.rank1_merge_core(t(d), t(z), t(rho))
    c = core.unsorted_c()
    s = m // 2
    g = rng(71)
    q_lo = t(g.standard_normal((2, 7, s)))
    q_hi = t(g.standard_normal((2, 5, m - s)), torch.float32)
    lam, (top, bot) = ts.rank1_merge_apply_parts(
        t(d), t(z), t(rho), ((q_lo, 0), (q_hi, s)), panel=panel)
    assert bot.dtype == torch.float32 and top.shape == (2, 7, m)
    np.testing.assert_allclose(n_(lam), n_(core.lam), atol=1e-12, rtol=0)
    np.testing.assert_allclose(n_(top), n_(q_lo @ c[:, :s]), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(n_(bot), n_(q_hi @ c[:, s:].float()),
                               atol=1e-5, rtol=0)
    lam2, q_new, aux_new = ts.rank1_merge_apply(
        t(d), t(z), t(rho), q_lo, q_lo[:, :2], 0, panel=panel)
    assert torch.equal(lam2, lam) and torch.equal(q_new, top)
    assert torch.equal(aux_new, top[:, :2])


def test_tiled_runs_equal_one_tile():
    """The run sums and the rotation in row tiles of 8 give the one-tile
    (m × m mask) form's rotation, on runs that straddle the tiles; a tile
    without a run of two is skipped."""
    d = np.repeat(np.arange(15.0), [1, 3, 7, 1, 2, 6, 4] + [1] * 8)
    d = np.stack([d, np.sort(rng(72).standard_normal(32))])
    z = rng(73).standard_normal((2, 32))
    tol = t(np.array([1e-12, 1e-12]))
    zr, u_hat, leaders, whole = ts._rotate_runs(t(d), t(z), tol, 32)
    zr2, u_hat2, leaders2, tiles = ts._rotate_runs(t(d), t(z), tol, 8)
    assert whole == [(0, 32, 0, 32)]
    assert torch.equal(leaders, leaders2)
    assert [tile[:2] for tile in tiles] == [(0, 8), (8, 16), (16, 24)]
    np.testing.assert_allclose(n_(zr2), n_(zr), atol=1e-15)
    np.testing.assert_allclose(n_(u_hat2), n_(u_hat), atol=1e-15)
    eye = torch.eye(32, dtype=torch.float64).expand(2, 32, 32)
    g = ts.apply_run_rotation(eye, u_hat, leaders, whole)
    g2 = ts.apply_run_rotation(eye, u_hat2, leaders, tiles)
    np.testing.assert_allclose(n_(g2), n_(g), atol=1e-15)
    np.testing.assert_allclose(n_(g2 @ g2.transpose(1, 2)), n_(eye),
                               atol=1e-14)


# the H100's free memory before an n = 32768 f32 solve: 80 GB less the
# resident input and the scaled working matrix
H100_FREE = 80e9 - 2 * 32768 ** 2 * 4


def test_memory_rule_with_the_h100_constants():
    assert not th._needs_windowed(32768, H100_FREE)           # eigen_s
    assert not th._needs_windowed(32768, H100_FREE, band=2)   # eigen_sx
    assert not th._needs_windowed(16384, 20e9)
    assert th._needs_windowed(65536, 80e9 - 2 * 65536 ** 2 * 4)
    assert th._needs_windowed(32768, 16e9)
    # f64 counts its matrices twice as large
    assert (th._rolled_peak_bytes(32768, 8) - th._rolled_peak_bytes(32768)
            == pytest.approx(th.PEAK_N2[1] * 32768 ** 2 * 4))
    # below the chunk width the widest merge is the whole tree
    assert (th._rolled_peak_bytes(8192) - th.PEAK_N2[1] * 8192 ** 2 * 4
            == pytest.approx(th.PEAK_MERGE[1] * 8192 ** 2 * 8))
    # the boundary is strict: a peak of exactly 0.9 of the memory fits
    n = 20000
    assert not th._needs_windowed(n, th._rolled_peak_bytes(n) / 0.9)


class _CardMatrix:
    """What ``_auto_impl`` reads of a tensor on the card."""

    def __init__(self, n, itemsize=4, is_complex=False):
        self.shape = (n, n)
        self.device = torch.device("cuda", 0)
        self._itemsize, self._complex = itemsize, is_complex

    def element_size(self):
        return self._itemsize

    def is_complex(self):
        return self._complex


def test_auto_reads_the_free_memory_of_a_card_tensor(monkeypatch):
    free = []
    monkeypatch.setattr(th, "_free_bytes", lambda dev: free[-1])
    free.append(H100_FREE)
    assert th._auto_impl(_CardMatrix(32768), band=1) == "rolled"
    free.append(16e9)
    assert th._auto_impl(_CardMatrix(32768), band=1) == "windowed"
    assert th._auto_impl(_CardMatrix(32768), band=2) == "windowed"
    # complex and CPU tensors stay rolled whatever the memory
    assert th._auto_impl(_CardMatrix(32768, 8, True), band=1) == "rolled"
    assert th._auto_impl(torch.zeros(4, 4), band=1) == "rolled"


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("chunk", [16, 50, 500])
def test_col_chunk_checks_equal_the_unchunked_ones(dtype, chunk):
    g = rng(74)
    n = 120
    x = g.standard_normal((n, n))
    if dtype.is_complex:
        x = x + 1j * g.standard_normal((n, n))
    a = t(x + x.conj().T, dtype)
    w, z = torch.linalg.eigh(a)
    # off the rounding floor: the Gram product's rounding (ε an entry, in
    # another order for a block) must stay below 1e-12 of the value, while
    # a block dropped or its identity misplaced moves the value by O(1)
    z = z + 1e-4 * t(g.standard_normal((n, n)), dtype)
    for check, args in ((residual_check, (a, z, w)),
                        (orthogonality_check, (z,))):
        whole = check(*args)
        for nvec in (None, 77):
            streamed = check(*args, nvec=nvec, col_chunk=chunk)
            ref = whole if nvec is None else check(*args, nvec=nvec)
            assert streamed.value == pytest.approx(ref.value, rel=1e-12)
