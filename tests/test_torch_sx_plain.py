"""The band-2 path of the port (``ops/band.band2_reduce``,
``solvers/dc_band.solve_band2_dc``, ``eigen_sx``) against the plain
reference ``eigenexa_tpu_torch/testing/plain_band2.py`` and
``torch.linalg.eigh``, on the CPU, in float64.  Nothing here imports JAX,
so these checks run where the JAX package is absent, as on the card's
machine.

Tolerances, in ε·‖A‖₂ (ε float64's):

* bands: 10·n.  The port (reflector pairs, CholeskyQR2, panels of 16
  with a deferred rank-32 update) and the plain reduction (one reflector a
  column applied at once) give the same (d, e1, e2) in exact arithmetic.
  Both are backward stable, but the last entries of a reduction are
  sensitive to rounding in all the reflectors before them: the two drift
  apart by a median 36 and at most 1229 (4.1·n) over 31 seeds at n = 300,
  as much as the port's own rolled and windowed reductions do, and by at
  most 241 over 3 seeds at n = 2048.  The port's float32 reduction misses
  10·n by 10⁵ and more;
* spectra (the pentadiagonal's against the input's, and the D&C's against
  ``eigh`` of the dense P): 10·n, the backward error of a Householder
  reduction and of a D&C, each O(n·ε·‖A‖);
* vectors: the reference's own acceptance numbers, residual < 768 and
  orthogonality < 8 (``benchmark/ev_test.f``).
"""

import ast
import inspect

import pytest

torch = pytest.importorskip("torch")

import eigenexa_tpu_torch as ext  # noqa: E402
from eigenexa_tpu_torch.ops import band as tb  # noqa: E402
from eigenexa_tpu_torch.solvers.dc_band import solve_band2_dc  # noqa: E402
from eigenexa_tpu_torch.testing import (orthogonality_check,  # noqa: E402
                                        plain_band2, residual_check)

EPS = torch.finfo(torch.float64).eps
SIZES = [33, 64, 130]
NB = 16      # panels at these sizes: the pair loop and the remainder both


def _sym(n, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(n, n, dtype=torch.float64, generator=g)
    return u + u.T          # the benchmark's random symmetric kind


def _norm2(a) -> float:
    return float(torch.linalg.eigvalsh(a).abs().max())


def _gap(x, y, scale) -> float:
    return float((x - y).abs().max()) / (EPS * scale)


@pytest.mark.parametrize("impl", ["rolled", "windowed"])
@pytest.mark.parametrize("n", SIZES)
def test_band2_reduce_bands_match_the_plain_reduction(n, impl):
    a = _sym(n, 190 + n)
    got = tb.band2_reduce(a, nb=NB, impl=impl)
    d, e1, e2 = plain_band2.band2_reduce(a)
    scale = _norm2(a)
    assert d.shape == (n,) and e1.shape == (n - 1,) and e2.shape == (n - 2,)
    for mine, plain in ((got.d, d), (got.e1.abs(), e1.abs()),
                        (got.e2.abs(), e2.abs())):
        assert _gap(mine, plain, scale) <= 10 * n
    # the float32 reduction of the same matrix misses the bound by far
    f32 = tb.band2_reduce(a.float(), nb=NB, impl=impl)
    assert _gap(f32.d.double(), d, scale) > 1e3 * 10 * n
    # the plain pentadiagonal keeps A's spectrum
    w = plain_band2.band2_eigvalsh(d, e1, e2)
    assert _gap(w, torch.linalg.eigvalsh(a), scale) <= 10 * n


@pytest.mark.parametrize("n", SIZES)
def test_solve_band2_dc_matches_eigh_of_the_dense_pentadiagonal(n):
    d, e1, e2 = plain_band2.band2_reduce(_sym(n, 290 + n))
    p = plain_band2.assemble(d, e1, e2)
    w_ref, _ = plain_band2.band2_eigh(d, e1, e2)
    w, s = solve_band2_dc(d, e1, e2)
    assert _gap(w, w_ref, _norm2(p)) <= 10 * n
    assert residual_check(p, s, w).passed
    assert orthogonality_check(s).passed


@pytest.mark.parametrize("n", SIZES)
def test_eigen_sx_mode_a_against_torch_eigh(n):
    a = _sym(n, 390 + n)
    w, z, _ = ext.eigen_sx(a, mode="A", ctx=ext.EigenContext(
        device=torch.device("cpu")))
    assert _gap(w, torch.linalg.eigh(a)[0], _norm2(a)) <= 10 * n
    assert residual_check(a, z, w).passed
    assert orthogonality_check(z).passed


def test_the_plain_reference_imports_torch_alone():
    tree = ast.parse(inspect.getsource(plain_band2))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"__future__", "torch"}
