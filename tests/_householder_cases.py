"""Cases and measures of the kernels of ``csrc/householder.cu`` (the
column's reflector, the band-2 pair's reflectors and update, the column's
update), shared by their CPU tests (the emulated kernels) and their card
tests, and the source's rewrite for the stand-in runtime; no JAX."""

import re

import numpy as np
import torch


def emulated(src: str) -> str:
    """csrc/householder.cu with each kernel's launches (every type)
    rewritten for the stand-in runtime of tests/cuda_emu."""
    for kernel in ("householder_vector_kernel", "pair_reflectors_kernel"):
        src, count = re.subn(
            rf"({kernel}<E>)<<<1, kThreads, 0,\s*"
            r"static_cast<cudaStream_t>\(stream\)>>>\(\s*",
            r"emu_launch(\1, 1, kThreads, ", src)
        assert count == 1, kernel
    # the pair's and the column's updates, three launches each over the
    # slabs
    for kernel in ("pair_update", "column_update"):
        src, count = re.subn(rf"({kernel}_\w+<E>)<<<blocks, kThreads, 0, "
                             r"s>>>\(\s*",
                             r"emu_launch(\1, blocks, kThreads, ", src)
        assert count == 3, kernel
    return src


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


# the band-2 reflector pair, ``pair_reflectors``

def pair_cases(dtype, ms=(5, 6, 66, 1000)):
    """(label, m, c0, x) of the reflector pair's checks, x (m, 2): random
    columns at c0 = 0, 2, m−4 (the second reflector's tail is empty) and
    m−3 (its pivot lies past the end) at each m; then at m = 66, c0 = 10
    a zero first column (CholeskyQR2 leaves the second alone), a zero
    second column, a second column parallel to the first (CholeskyQR2
    leaves rounding), a first column zero below its pivot (reflector 0
    idles), a negative pivot, and both columns scaled by 1e−100 (f64) or
    1e−15 (f32), whose Gram products sit near the bottom of the range."""
    g = np.random.default_rng(19)
    out = [(f"m{m}_c{c0}", m, c0, g.standard_normal((m, 2))) for m in ms
           for c0 in sorted({0, 2, m - 4, m - 3}) if 0 <= c0 < m - 2]
    small = 1e-100 if dtype == torch.float64 else 1e-15
    m, c0 = 66, 10
    p = c0 + 2
    for edit in ("zero_first", "zero_second", "parallel", "zero_tail",
                 "negative_alpha", "small"):
        x = g.standard_normal((m, 2))
        if edit == "zero_first":
            x[:, 0] = 0
        elif edit == "zero_second":
            x[:, 1] = 0
        elif edit == "parallel":
            x[:, 1] = -3 * x[:, 0]
        elif edit == "zero_tail":
            x[p + 1:, 0] = 0
        elif edit == "negative_alpha":
            x[p, 0] = -abs(x[p, 0]) - 1
        elif edit == "small":
            x *= small
        out.append((edit, m, c0, x))
    return out


def pair_error(got, ref, dtype, second: bool = True) -> float:
    """The largest distance of (V, τ, T) from the plain version's, each of
    V's columns, τ's entries and T in units of ε times the largest entry
    of the plain version's piece; NaN and infinities must sit where the
    plain version has them.  Without `second`, the second reflector (V's
    second column, τ₁ and T's last column) is left out."""
    v, tau, t = (np.asarray(a, np.float64) for a in got)
    rv, rtau, rt = (np.asarray(a, np.float64) for a in ref)
    pieces = [(v[:, 0], rv[:, 0]), (tau[:1], rtau[:1]), (t[0, :1], rt[0, :1])]
    if second:
        pieces += [(v[:, 1], rv[:, 1]), (tau[1:], rtau[1:]), (t, rt)]
    worst = 0.0
    for a, r in pieces:
        same = (a == r) | (np.isnan(a) & np.isnan(r))
        if not (np.isfinite(a[~same]).all() and np.isfinite(r[~same]).all()):
            return np.inf
        if same.all():
            continue
        scale = np.abs(r[np.isfinite(r)]).max(initial=0.0)
        if scale == 0:
            return np.inf
        worst = max(worst, float(np.abs(a[~same] - r[~same]).max()) / (
            float(torch.finfo(dtype).eps) * scale))
    return worst


def pair_identity_error(x, c0: int, v, t) -> float:
    """How far Hᵀ = I − V·Tᵀ·Vᵀ falls short of zeroing column 0 of x below
    its pivot c0+2 and column 1 below c0+3 (the rows above c0+2 taken as
    zero): the largest such entry over ε·‖column‖, in float64 whatever
    x's type; ε is x's."""
    xd = torch.as_tensor(np.asarray(x), dtype=torch.float64).clone()
    p = c0 + 2
    xd[:p] = 0
    vd = torch.as_tensor(np.array(v), dtype=torch.float64)
    td = torch.as_tensor(np.array(t), dtype=torch.float64)
    y = xd - vd @ (td.T @ (vd.T @ xd))
    eps = torch.finfo(torch.as_tensor(np.asarray(x)).dtype).eps
    worst = 0.0
    for j, below in ((0, p + 1), (1, p + 2)):
        scale = float(torch.linalg.vector_norm(xd[:, j]))
        tail = y[below:, j]
        err = float(tail.abs().max()) if tail.numel() else 0.0
        if err:
            worst = max(worst, err / (eps * scale))
    return worst


# the band-2 pair's update, ``pair_update``

def update_cases(dtype, ms=(5, 66, 1000)):
    """(label, m, c0, j0, ldu, b_v, u, w, v, t) of the pair update's checks:
    random panels with c0 = 0, 2, 30 and 62 earlier columns (a panel of
    64; past 100 rows only 0 and 62, which take no chunk and two) at each
    m, W zeroed before row j0 = 0 or m // 3; then at m = 40 the most
    earlier columns the kernel takes (256), and a zero B·V.  U and W have
    two columns of padding past the pair's."""
    g = np.random.default_rng(23)
    out = []

    def case(label, m, c0, j0):
        ldu = c0 + 4
        t = g.standard_normal((2, 2))
        t[1, 0] = 0
        return (label, m, c0, j0, ldu, g.standard_normal((m, 2)),
                g.standard_normal((m, ldu)), g.standard_normal((m, ldu)),
                g.standard_normal((m, 2)), t)

    for m in ms:
        for c0 in (0, 2, 30, 62) if m <= 100 else (0, 62):
            for j0 in sorted({0, m // 3}):
                out.append(case(f"m{m}_c{c0}_j{j0}", m, c0, j0))
    out.append(case("widest", 40, 256, 0))
    zero = case("zero_bv", 66, 30, 0)
    out.append(zero[:5] + (np.zeros((66, 2)),) + zero[6:])
    return out


def update_error(u, w, ref_u, ref_w, c0: int, dtype) -> float:
    """The distance of the kernel's panel (u, w) from the plain version's:
    W's two new columns in √m·ε of the largest entry of the plain
    version's (Vᵀ·P sums over the m rows), and infinity where U's new
    columns or any other entry of U or W differ in a bit."""
    u, w, ref_u, ref_w = (np.asarray(a) for a in (u, w, ref_u, ref_w))
    new = slice(c0, c0 + 2)
    rest = np.ones(w.shape[1], bool)
    rest[new] = False
    if (u.tobytes() != ref_u.tobytes()
            or w[:, rest].tobytes() != ref_w[:, rest].tobytes()):
        return np.inf
    got, ref = w[:, new].astype(np.float64), ref_w[:, new].astype(np.float64)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        return np.inf
    diff = np.abs(got - ref).max(initial=0.0)
    if diff == 0:
        return 0.0
    return float(diff) / (float(torch.finfo(dtype).eps) * got.shape[0] ** 0.5
                          * float(np.abs(ref).max()))


# the tridiagonal column's update, ``column_update``

def column_cases(dtype, ms=(5, 66, 1000), js=(0, 1, 30, 63), big_js=None):
    """(label, m, c0, j, j0, ldu, b_v, u, w, v, tau) of the column update's
    checks: at each m, panels of 64 columns whose column j is the one
    being formed, corrected by the c0 = j before it (the rolled column:
    the columns from j on zero), W zeroed before row j0 = 0 or m // 3
    (past 100 rows only the j of `big_js`, by default the first and last
    of `js`: j = 0 and 63 take no chunk and two); then a
    windowed column, c0 = 0 at j = 5 with every other column of U and W
    random; at m = 40 the most correcting columns the kernel takes (256);
    a zero B·v; τ = 0 with v = 0 (the remainder's last column).  U and W
    have two columns of padding past the panel's."""
    g = np.random.default_rng(29)
    out = []

    def case(label, m, c0, j, j0, ldu, rest=False):
        u, w = g.standard_normal((m, ldu)), g.standard_normal((m, ldu))
        if not rest:
            u[:, j:] = 0
            w[:, j:] = 0
        return (label, m, c0, j, j0, ldu, g.standard_normal(m), u, w,
                g.standard_normal(m), g.standard_normal(1))

    for m in ms:
        for j in js if m <= 100 else (big_js or (js[0], js[-1])):
            for j0 in sorted({0, m // 3}):
                out.append(case(f"m{m}_j{j}_j0{j0}", m, j, j, j0, 66))
        out.append(case(f"m{m}_windowed", m, 0, 5, m // 3, 66, rest=True))
    out.append(case("widest", 40, 256, 256, 0, 260))
    zero = case("zero_bv", 66, 30, 30, 0, 66)
    out.append(zero[:6] + (np.zeros(66),) + zero[7:])
    last = case("tau_0", 66, 63, 63, 0, 66)
    out.append(last[:9] + (np.zeros(66), np.zeros(1)))
    return out


def column_error(u, w, ref_u, ref_w, j: int, dtype) -> float:
    """The distance of the kernel's panel (u, w) from the plain version's:
    W's column j in √m·ε of the largest entry of the plain version's (vᵀq
    sums over the m rows), and infinity where U's column j or any other
    entry of U or W differ in a bit."""
    u, w, ref_u, ref_w = (np.asarray(a) for a in (u, w, ref_u, ref_w))
    rest = np.ones(w.shape[1], bool)
    rest[j] = False
    if (u.tobytes() != ref_u.tobytes()
            or w[:, rest].tobytes() != ref_w[:, rest].tobytes()):
        return np.inf
    got, ref = w[:, j].astype(np.float64), ref_w[:, j].astype(np.float64)
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        return np.inf
    diff = np.abs(got - ref).max(initial=0.0)
    if diff == 0:
        return 0.0
    return float(diff) / (float(torch.finfo(dtype).eps) * got.shape[0] ** 0.5
                          * float(np.abs(ref).max()))
