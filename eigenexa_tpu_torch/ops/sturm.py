"""Sturm-sequence bisection for the symmetric tridiagonal and pentadiagonal
eigenproblems (modes N and X).

Counterpart of ``eigenexa_tpu/ops/sturm.py`` (reference: src/bisect.F:67
``eigen_bisect`` — Gershgorin bounds, Sturm counts, and the mode-X
refinement of D&C eigenvalues; src/bisect2.F:71 ``eigen_bisect2`` for the
pentadiagonal).  All math is f64 whatever the solve's dtype.

The JAX package runs the recurrence as one ``lax.scan`` over n for all
probes at once, inside a ``lax.fori_loop`` of bisection steps, which XLA
compiles into one program.  Here the bisection and refinement functions
hand their brackets to ``kernels.sturm_bisect``: the plain PyTorch loop on
the CPU, the hand-written ``csrc/sturm.cu`` on the card, where one thread
owns one eigenvalue index.  The counts alone (``sturm_count``,
``sturm_count_band2``) have no kernel and run on the CPU only: the
recurrence never runs as an eager loop on the card.
"""

from __future__ import annotations

import torch

from eigenexa_tpu_torch.ops import kernels

F64 = torch.float64


def _cpu_only(fn: str, d: torch.Tensor) -> None:
    if d.device.type != "cpu":
        raise NotImplementedError(
            f"{fn}: counts alone run on the CPU; on the card, bisection and "
            "refinement go through kernels.sturm_bisect")


def sturm_count(d, e, x):
    """Number of eigenvalues of T(d, e) strictly below each probe of ``x``
    (k,) → int32 (k,), with the dlaebz-style pivmin guard."""
    _cpu_only("sturm_count", d)
    bands, head = kernels.sturm_setup(d, e)
    return kernels._sturm_count_ref(bands, head, x.to(F64))


def sturm_count_band2(d, e1, e2, x):
    """Number of eigenvalues of the pentadiagonal T(d, e1, e2) strictly
    below each probe of ``x``: the inertia of Gaussian elimination of
    T − xI over the 2×2 trailing window (a, b, c), tiny pivots clamped to
    ±pivmin (reference: src/bisect2.F:115)."""
    _cpu_only("sturm_count_band2", d)
    bands, head = kernels.sturm_setup(d, e1, e2)
    return kernels._sturm_count_ref(bands, head, x.to(F64))


def gershgorin_bounds(d, e):
    """(lower, upper) bounds on the spectrum of T(d, e), 0-d f64 tensors
    (reference: bisect.F:101-149)."""
    d = d.to(F64)
    ae = e.to(F64).abs()
    zero = d.new_zeros(1)
    r = torch.cat([zero, ae]) + torch.cat([ae, zero])
    return (d - r).amin(), (d + r).amax()


def gershgorin_bounds_band2(d, e1, e2):
    """Spectrum bounds for the pentadiagonal T(d, e1, e2)."""
    d = d.to(F64)
    a1 = e1.to(F64).abs()
    a2 = e2.to(F64).abs()
    r = torch.zeros_like(d)
    r[:-1] += a1
    r[1:] += a1
    if a2.shape[0] > 0:
        r[:-2] += a2
        r[2:] += a2
    return (d - r).amin(), (d + r).amax()


def bisect_brackets(d, e1, e2=None):
    """(a0, b0) of the full bisection: for every index the Gershgorin
    interval of T(d, e1[, e2]) widened by 1e-6 of its span."""
    n = d.shape[0]
    lo, hi = (gershgorin_bounds(d, e1) if e2 is None
              else gershgorin_bounds_band2(d, e1, e2))
    span = torch.clamp_min(hi - lo, 1e-30)
    lo = lo - 1e-6 * span
    hi = hi + 1e-6 * span
    return lo.expand(n), hi.expand(n)


def refine_brackets(w0):
    """(a0, b0) of the refinement: local brackets around each w0, half the
    wider neighbouring gap on either side (at least 1e-12·|w0| + 1e-14)."""
    w0 = w0.to(F64)
    if w0.shape[0] > 1:
        gaps = torch.diff(w0)
        pad = torch.cat([gaps[:1], gaps])
    else:
        pad = torch.ones_like(w0)
    half = torch.maximum(
        0.5 * torch.maximum(pad, torch.cat([pad[1:], pad[-1:]])),
        w0.abs() * 1e-12 + 1e-14)
    return w0 - half, w0 + half


def eigvals_bisect(d, e, n_iter: int = 70):
    """All eigenvalues of T(d, e), ascending, f64: each index i keeps a
    bracket with count(a_i) ≤ i < count(b_i), and every step probes its
    midpoint; 70 halvings of the Gershgorin interval reach f64 accuracy."""
    return kernels.sturm_bisect(d, e, None, *bisect_brackets(d, e), n_iter)


def eigvals_bisect_band2(d, e1, e2, n_iter: int = 70):
    """All pentadiagonal eigenvalues, ascending, f64 (reference:
    eigen_bisect2, src/bisect2.F:71)."""
    return kernels.sturm_bisect(d, e1, e2, *bisect_brackets(d, e1, e2),
                                n_iter)


def refine_eigenvalues(d, e, w0, n_iter: int = 45):
    """Sharpen approximate eigenvalues of T(d, e) (the reference's mode-X
    refinement of the D&C output, bisect.F mode=1); an index whose local
    bracket does not hold it keeps w0."""
    return kernels.sturm_bisect(d, e, None, *refine_brackets(w0), n_iter,
                                check_valid=True, w0=w0.to(F64))


def refine_eigenvalues_band2(d, e1, e2, w0, n_iter: int = 45):
    """Sharpen approximate pentadiagonal eigenvalues (mode X of
    ``eigen_sx``, through eigen_bisect2)."""
    return kernels.sturm_bisect(d, e1, e2, *refine_brackets(w0), n_iter,
                                check_valid=True, w0=w0.to(F64))
