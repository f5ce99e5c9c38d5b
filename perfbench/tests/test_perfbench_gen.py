"""The generator: the same seed gives the same bits, another seed other
ones, any whole seed of 64 bits is taken, and a designed matrix has the
spectrum it was designed with."""

import pytest
import torch

from perfbench import gen

KINDS = [{"kind": "random_symmetric"},
         {"kind": "designed", "spectrum": "multiplicity"}]


@pytest.mark.parametrize("spec", KINDS, ids=lambda s: s["kind"])
@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3, -5])
def test_same_seed_same_bits(spec, seed):
    a = gen.make_matrix(spec, 48, "float64", seed, "cpu")
    b = gen.make_matrix(spec, 48, "float64", seed, "cpu")
    c = gen.make_matrix(spec, 48, "float64", seed + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a.T)


def test_random_range():
    a = gen.make_matrix(KINDS[0], 64, "float64", 3, "cpu")
    assert a.min() >= 0.0 and a.max() <= 2.0


def test_designed_spectrum():
    n = 60
    a = gen.make_matrix(KINDS[1], n, "float64", 11, "cpu")
    w = gen.spectrum("multiplicity", n, "cpu")
    got = torch.linalg.eigvalsh(a)
    assert torch.allclose(got, torch.sort(w).values, atol=1e-10 * max(
        1.0, float(w.abs().max())))


def test_multiplicity_has_six_values_of_high_multiplicity():
    w = gen.spectrum("multiplicity", 100, "cpu")
    counts = {v: w.tolist().count(v) for v in set(w.tolist())}
    assert counts == {0.0: 10, 1.0: 20, 2.0: 20, 3.0: 20, 4.0: 20, 5.0: 10}


@pytest.mark.parametrize("spec", [{"kind": "designed", "spectrum": "sin3"},
                                  {"kind": "banded"}], ids=["spectrum", "kind"])
def test_an_unknown_name_is_refused(spec):
    with pytest.raises(ValueError, match="unknown"):
        gen.make_matrix(spec, 16, "float64", 1, "cpu")
