"""The real tridiagonal column's update (``kernels.column_update``) and the
TRD panel loops that call it, without a card.

A CPU tensor takes the plain version (``kernels._column_update_ref``) and
counts no launch, and the panel loops on the CPU give, bit for bit, what
the column's op-by-op body gave before its update was one call (the
``_parent_*`` functions below keep that body as it was).  The CUDA source
itself is built by the host compiler against the stand-in runtime of
``tests/cuda_emu`` with ``column_update_main.cpp`` as its main (the 512
threads of a block as fibers resumed in a shuffled order) and held to the
plain version: W's column j within ``EPS``·√m·ε, U's column j v's bits,
every other entry of U and W untouched, nothing written past them, a rerun
bitwise equal.  Broken copies must fail: a dropped correction, a wrong
half, the barrier after the slabs' sums dropped.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _householder_cases import (NP, column_cases, column_error,  # noqa: E402
                                emulated)

from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TYPES = {"f32": torch.float32, "f64": torch.float64}
# W's column j within EPS·√m·ε of the largest entry of the plain version's:
# the sums over the panel's columns and the m rows run in another order
EPS = 4
# edits of the column's kernels that the cases must catch
MUTANTS = {
    # q loses W·(Uᵀv)
    "dropped_correction": ("q = E::sub_rn(E::sub_rn(q, s[0]), s[1]);",
                           "q = E::sub_rn(q, s[0]);"),
    # w = τq − τ²(vᵀq)·v, the half left out
    "wrong_half": ("E::mul_rn(E::mul_rn(t, t), R(0.5))",
                   "E::mul_rn(t, t)"),
    # a block's rows read Wᵀv and Uᵀv before the slabs' sums are in
    "dropped_barrier": ("    cwu[e / 2][e % 2] = total;\n  }\n"
                        "  __syncthreads();\n",
                        "    cwu[e / 2][e % 2] = total;\n  }\n"),
}


# ---------------------------------------------------------------------------
# the column's body as it was before column_update: the CPU's oracle
# ---------------------------------------------------------------------------

def _parent_panel_body(j, b, u_p, w_p, tau_p, e_p):
    col = b[:, j] - u_p @ w_p[j].conj() - w_p @ u_p[j].conj()
    v, tau, beta = tk.householder_vector(col, j + 1)
    q = b @ v - u_p @ (w_p.conj().T @ v) - w_p @ (u_p.conj().T @ v)
    w = tau * q - (tau * tau.conj() * 0.5) * torch.vdot(v, q) * v
    u_p[:, j] = v
    w_p[:, j] = w
    tau_p[j] = tau
    e_p[j] = beta


def _parent_tridiag_panel(b, nb):
    m = b.shape[0]
    u_p = b.new_zeros((m, nb))
    w_p = b.new_zeros((m, nb))
    tau_p = b.new_zeros((nb,))
    e_p = b.real.new_zeros((nb,))
    for j in range(nb):
        _parent_panel_body(j, b, u_p, w_p, tau_p, e_p)
    return u_p, w_p, tau_p, e_p


def _parent_panel_win(b, j0, t0, nb, ws):
    n = b.shape[0]
    uw = b.new_zeros((n, 2 * nb))
    u_p, w_p = uw[:, :nb], uw[:, nb:]
    tau_p = b.new_zeros((nb,))
    e_p = b.new_zeros((nb,))
    for jc in range(nb):
        j = j0 + jc
        col = b[:, j] - u_p @ w_p[j] - w_p @ u_p[j]
        v, tau, beta = tk.householder_vector(col, j + 1)
        q = tk.symv_lower(b, v, t0=t0, panel=uw, nb=jc, **ws)
        w = tau * q - (tau * tau * 0.5) * torch.dot(v, q) * v
        w[:j0] = 0
        u_p[:, jc] = v
        w_p[:, jc] = w
        tau_p[jc] = tau
        e_p[jc] = beta
    return u_p, w_p, tau_p, e_p


def _symmetric(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((n, n), generator=g, dtype=torch.float64)
    return (a + a.T).to(dtype)


def _same_bits(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert g.numpy().tobytes() == r.numpy().tobytes()


@pytest.mark.parametrize("kind", list(TYPES))
def test_a_cpu_tensor_takes_the_plain_column_update(kind):
    """On the CPU ``column_update`` is the plain version bit for bit, on
    the rolled column (corrections over the panel) and the windowed one
    (none, W zeroed before j0), and counts no launch."""
    dtype = TYPES[kind]
    before = dict(tk.LAUNCHES)
    for _, m, c0, j, j0, _, bv, u, w, v, tau in column_cases(dtype,
                                                            ms=(40,)):
        args = [torch.as_tensor(a, dtype=dtype) for a in (bv, u, w, v, tau)]
        ref = [a.clone() for a in args]
        tk.column_update(args[0], args[1], args[2], j, args[3], args[4][0],
                         corrections=c0 == j, zero_rows=j0,
                         scratch=tk.column_update_scratch(args[1]))
        tk._column_update_ref(ref[0], ref[1], ref[2], j, ref[3], ref[4][0],
                              corrections=c0 == j, zero_rows=j0)
        _same_bits(args, ref)
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("kind", list(TYPES))
def test_panels_give_the_parent_bits_on_the_cpu(kind):
    """``tridiag_panel`` (a full panel and a remainder whose last pivot
    lies past it) and ``_panel_win`` (a panel below a stale frame) give
    U, W, τ and e bit for bit as the op-by-op column did."""
    dtype = TYPES[kind]
    b = _symmetric(120, dtype, 31)
    for width in (16, 12):
        blk = b[:width, :width] if width == 12 else b
        _same_bits(th.tridiag_panel(blk.clone(), width),
                   _parent_tridiag_panel(blk.clone(), width))
    j0, nb = 32, 16
    got = th._panel_win(b.clone(), j0, 0, nb,
                        tk.symv_workspace(b, panel_cols=2 * nb))
    ref = _parent_panel_win(b.clone(), j0, 0, nb,
                            tk.symv_workspace(b, panel_cols=2 * nb))
    _same_bits(got, ref)


@pytest.mark.parametrize("impl", ["rolled", "windowed"])
@pytest.mark.parametrize("kind", list(TYPES))
def test_reduction_gives_the_parent_bits_on_the_cpu(kind, impl,
                                                    monkeypatch):
    """A whole reduction of n = 150 in panels of 16 (a remainder of 6):
    d, e, v and τ bit for bit what the op-by-op column gave."""
    dtype = TYPES[kind]
    a = _symmetric(150, dtype, 37)
    got = th.tridiagonalize(a, nb=16, impl=impl)
    monkeypatch.setattr(th, "tridiag_panel", _parent_tridiag_panel)
    monkeypatch.setattr(th, "_panel_win", _parent_panel_win)
    ref = th.tridiagonalize(a, nb=16, impl=impl)
    _same_bits(got, ref)


# ---------------------------------------------------------------------------
# csrc/householder.cu's column kernels on CPU threads
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def column_emu(tmp_path_factory):
    """csrc/householder.cu built against the stand-in runtime with
    column_update_main.cpp as its main: the source as it is and each
    mutant of MUTANTS, compiled at once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    root = tmp_path_factory.mktemp("column_emu")
    procs = {}
    for name in (None, *MUTANTS):
        src = (REPO / "eigenexa_tpu_torch" / "csrc" /
               "householder.cu").read_text()
        if name is not None:
            old, new = MUTANTS[name]
            assert src.count(old) == 1, name
            src = src.replace(old, new)
        d = root / (name or "source")
        d.mkdir()
        (d / "kern.cpp").write_text(emulated(src))
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", f"-I{d}",
             "-Wno-unknown-pragmas", "-o", str(d / "emu"),
             str(emu / "column_update_main.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: root / (name or "source") / "emu" for name in procs}


def _run_emu(binary, kind, tmp_path, ms=(5, 66, 1000)):
    """The column cases of ``kind`` at ``ms`` (and the fixed ones of
    ``column_cases``) through the emulated kernels: (the run, the number of cases, the largest ``column_error``
    over them)."""
    dtype = TYPES[kind]
    np_type = NP[dtype]
    cases = column_cases(dtype, ms)
    src, dst = tmp_path / f"{kind}.in", tmp_path / f"{kind}.out"
    with open(src, "wb") as f:
        for _, m, c0, j, j0, ldu, bv, u, w, v, tau in cases:
            f.write(np.array([m, c0, j, j0, ldu], np.int32).tobytes())
            for a in (bv, u, w, v, tau):
                f.write(np.asarray(a, np_type).tobytes())
    run = subprocess.run([str(binary), kind, str(src), str(dst)],
                         capture_output=True, text=True, timeout=300)
    buf = dst.read_bytes() if dst.exists() else b""
    size = np.dtype(np_type).itemsize
    worst, off = 0.0, 0
    for _, m, c0, j, j0, ldu, bv, u, w, v, tau in cases:
        if off + 2 * m * ldu * size > len(buf):
            return run, len(cases), np.inf
        got_u = np.frombuffer(buf, np_type, m * ldu, off).reshape(m, ldu)
        got_w = np.frombuffer(buf, np_type, m * ldu,
                              off + m * ldu * size).reshape(m, ldu)
        off += 2 * m * ldu * size
        ref = [torch.as_tensor(np.asarray(a, np_type)).clone()
               for a in (bv, u, w, v, tau)]
        tk._column_update_ref(ref[0], ref[1], ref[2], j, ref[3], ref[4][0],
                              corrections=c0 == j, zero_rows=j0)
        worst = max(worst, column_error(got_u, got_w, ref[1].numpy(),
                                        ref[2].numpy(), j, dtype))
    return run, len(cases), worst


@pytest.mark.parametrize("kind", list(TYPES))
def test_column_source_matches_the_plain_version_on_cpu_threads(
        column_emu, kind, tmp_path):
    """The column's kernels of csrc/householder.cu, run as fibers on a CPU
    thread over several slabs (m = 1000) and one: W's column j within
    ``EPS`` of the plain version (zero before j0), U's column j v's bits,
    every other entry of U and W untouched, a guard past them kept, a
    rerun bitwise equal, B·v, v and τ untouched."""
    run, count, worst = _run_emu(column_emu[None], kind, tmp_path)
    assert run.returncode == 0, (run.stdout, run.stderr)
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL OK"
    assert len(lines) == count + 1
    assert worst <= EPS, worst


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_column_source_mutants_fail_on_cpu_threads(column_emu, mutant,
                                                   tmp_path):
    """The cases have teeth: q without one correction, w without the half
    of ½τ²(vᵀq)·v, and rows summed before the slabs' sums are in are each
    another column."""
    run, _, worst = _run_emu(column_emu[mutant], "f64", tmp_path, ms=(66,))
    assert run.returncode != 0 or worst > EPS
