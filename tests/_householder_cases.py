"""Cases and measures of the column's reflector, ``householder_vector``,
shared by its CPU tests (the emulated kernel) and its card tests; no JAX."""

import numpy as np
import torch

NP = {torch.float32: np.float32, torch.float64: np.float64,
      torch.complex64: np.complex64, torch.complex128: np.complex128}


def reflector_cases(dtype, ms=(1, 2, 3, 65, 1000)):
    """(label, m, p, x) of the checks: pivots 0, 1, m−2 and m−1 at each m,
    then at m = 65 a zero tail, α = 0, x = 0, a negative α, tails scaled by
    1e∓300 (f64, c128) or 1e∓30 (f32, c64), and for complex types a
    nonzero α with a zero tail, where only the phase rotation acts."""
    g = np.random.default_rng(7)

    def draw(m):
        x = g.standard_normal(m)
        return x + 1j * g.standard_normal(m) if dtype.is_complex else x

    out = [(f"m{m}_p{p}", m, p, draw(m)) for m in ms
           for p in sorted({0, 1, m - 2, m - 1}) if 0 <= p < m]
    small = 1e-300 if dtype in (torch.float64, torch.complex128) else 1e-30
    m, p = 65, 10
    for edit in ("zero_tail", "alpha_0", "all_0", "negative_alpha",
                 "tail_small", "tail_large", "phase", "phase_negative"):
        if edit.startswith("phase") and not dtype.is_complex:
            continue
        x = draw(m)
        if edit in ("zero_tail", "phase", "phase_negative"):
            x[p + 1:] = 0
        if edit == "phase":
            x[p] = 0.5 + 0.75j
        elif edit == "phase_negative":
            x[p] = -0.5 - 0.75j
        elif edit == "alpha_0":
            x[p] = 0
        elif edit == "all_0":
            x[:] = 0
        elif edit == "negative_alpha":
            x[p] = -abs(x[p]) - 1
        elif edit == "tail_small":
            x[p + 1:] *= small
        elif edit == "tail_large":
            x[p + 1:] /= small
        out.append((edit, m, p, x))
    return out


def ulps(got, ref, dtype) -> float:
    """The largest |got − ref| / (ε·|ref|) over the entries, where NaN and
    infinities must match exactly (an exact zero of ref must be matched
    exactly too)."""
    got = np.asarray(got, np.complex128).ravel()
    ref = np.asarray(ref, np.complex128).ravel()
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    if not np.isfinite(ref[~same]).all() or not np.isfinite(got[~same]).all():
        return np.inf
    diff = np.abs(got[~same] - ref[~same])
    with np.errstate(divide="ignore"):
        rel = diff / np.abs(ref[~same])
    return float(rel.max(initial=0.0)) / torch.finfo(dtype).eps


def identity_error(x, p: int, v, tau, beta) -> float:
    """max |Hᴴx − t| / (ε·‖x[p:]‖) with H = I − τ·v·vᴴ, t = x above p, β at
    p and 0 below, in float64 (complex128) whatever x's type; ε is x's."""
    wide = torch.complex128 if x.is_complex() else torch.float64
    xd, vd, td = x.to(wide), v.to(wide), tau.to(wide)
    y = xd - td.conj() * vd * torch.vdot(vd, xd)
    want = xd.clone()
    want[p] = beta.to(torch.float64)
    want[p + 1:] = 0
    scale = float(torch.linalg.vector_norm(xd[p:]))
    err = float((y - want).abs().max())
    if err == 0:
        return 0.0
    return err / (torch.finfo(x.dtype).eps * scale)
