"""The column's reflector kernel (``csrc/householder.cu``) without a card.

A CPU tensor takes the plain version (``kernels._householder_vector_ref``)
and counts no launch.  The CUDA source itself is built by the host
compiler against the stand-in runtime of ``tests/cuda_emu`` (the 512
threads of the block as fibers resumed in a shuffled order) and held to the
plain version: v, tau and beta within ``ULPS`` units in the last place of
each entry (the kernel's two sums run in another order than torch's; a
NaN or an infinity must sit where the plain version has it), and a rerun
bitwise equal.  Two broken copies must fail: one without the barrier
between the scalars and the writes of v, one without dlarfg's pre-scale.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _householder_cases import (NP, emulated, reflector_cases,  # noqa: E402
                                ulps)

from eigenexa_tpu_torch.ops import householder as th  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ULPS = 8
TYPES = {"f32": torch.float32, "f64": torch.float64,
         "c64": torch.complex64, "c128": torch.complex128}
# edits of csrc/householder.cu that the cases must catch, and the type they
# are run in
MUTANTS = {
    # the threads write v before thread 0 has set the divisor and the pivot
    "dropped_barrier": ("    active = on;\n  }\n  __syncthreads();\n",
                        "    active = on;\n  }\n", "f64"),
    # the squares taken unscaled: a tail of 1e-300 underflows to a norm of 0
    "no_prescale": ("MaxNan()(block_reduce(big, partial, MaxNan()), "
                    "E::kTiny)", "R(1)", "f64"),
}


def test_a_cpu_tensor_takes_the_plain_version():
    """On the CPU ``householder_vector`` is the plain version bit for bit,
    and it counts no launch."""
    before = tk.LAUNCHES["householder_vector"]
    for dtype in TYPES.values():
        for _, m, p, x in reflector_cases(dtype, ms=(5, 40)):
            xt = torch.as_tensor(x, dtype=dtype)
            for got, ref in zip(th.householder_vector(xt, p),
                                tk._householder_vector_ref(xt, p)):
                assert got.dtype == ref.dtype and got.shape == ref.shape
                assert got.numpy().tobytes() == ref.numpy().tobytes()
    assert tk.LAUNCHES["householder_vector"] == before


@pytest.fixture(scope="module")
def reflector_emu(tmp_path_factory):
    """csrc/householder.cu built by the host compiler against the stand-in
    runtime of tests/cuda_emu, with householder_main.cpp as its main: the
    source as it is and each mutant of MUTANTS, compiled at once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    root = tmp_path_factory.mktemp("householder_emu")
    procs = {}
    for name in (None, *MUTANTS):
        src = (REPO / "eigenexa_tpu_torch" / "csrc" /
               "householder.cu").read_text()
        if name is not None:
            old, new, _ = MUTANTS[name]
            assert src.count(old) == 1, name
            src = src.replace(old, new)
        src = emulated(src)
        d = root / (name or "source")
        d.mkdir()
        (d / "kern.cpp").write_text(src)
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", f"-I{d}",
             "-Wno-unknown-pragmas", "-o", str(d / "emu"),
             str(emu / "householder_main.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: root / (name or "source") / "emu" for name in procs}


def _run_emu(binary, kind, tmp_path):
    """The cases of ``kind`` through the emulated kernel: (the run, the
    largest distance in ULPs from the plain version over every case).  In
    the complex overflow case (a tail of 1e300 or 1e30) v is left out:
    there the CPU's vectorised complex division meets the infinite
    divisor α − β with NaN where c10::complex's, which the card's torch
    and the kernel take, gives 0; the card tests hold it."""
    dtype = TYPES[kind]
    cases = reflector_cases(dtype)
    src, dst = tmp_path / f"{kind}.in", tmp_path / f"{kind}.out"
    with open(src, "wb") as f:
        for _, m, p, x in cases:
            f.write(np.array([m, p], np.int32).tobytes())
            f.write(np.asarray(x, NP[dtype]).tobytes())
    run = subprocess.run([str(binary), kind, str(src), str(dst)],
                         capture_output=True, text=True, timeout=120)
    buf = dst.read_bytes() if dst.exists() else b""
    real = NP[torch.empty((), dtype=dtype).real.dtype]
    size, rsize = np.dtype(NP[dtype]).itemsize, np.dtype(real).itemsize
    worst, off = 0.0, 0
    for label, m, p, x in cases:
        if off + m * size + size + rsize > len(buf):
            return run, np.inf
        v = np.frombuffer(buf, NP[dtype], m, off)
        tau = np.frombuffer(buf, NP[dtype], 1, off + m * size)
        beta = np.frombuffer(buf, real, 1, off + (m + 1) * size)
        off += (m + 1) * size + rsize
        ref = tk._householder_vector_ref(
            torch.as_tensor(np.asarray(x, NP[dtype])), p)
        held = zip((v, tau, beta), ref)
        if label == "tail_large" and dtype.is_complex:
            held = list(held)[1:]
        worst = max([worst] + [ulps(got, r.numpy(), dtype)
                               for got, r in held])
    return run, worst


@pytest.mark.parametrize("kind", list(TYPES))
def test_reflector_source_matches_the_plain_version_on_cpu_threads(
        reflector_emu, kind, tmp_path):
    """csrc/householder.cu itself, run as fibers on a CPU thread (see
    `reflector_emu`): every case within ``ULPS`` of the plain version, with
    its NaN and infinities where the plain version has them (a tail of
    1e300 or 1e30 overflows sqrt(α² + ‖x‖²) in both), a rerun bitwise
    equal, x untouched and nothing written past the outputs."""
    run, worst = _run_emu(reflector_emu[None], kind, tmp_path)
    assert run.returncode == 0, (run.stdout, run.stderr)
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL OK"
    assert len(lines) == len(reflector_cases(TYPES[kind])) + 1
    assert worst <= ULPS, worst


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_reflector_source_mutants_fail_on_cpu_threads(reflector_emu, mutant,
                                                      tmp_path):
    """The cases have teeth: threads that write v before the barrier read
    a divisor and pivot that are not yet set; without the pre-scale a tail
    of 1e-300 squares to 0 and the reflector goes inactive."""
    kind = MUTANTS[mutant][2]
    run, worst = _run_emu(reflector_emu[mutant], kind, tmp_path)
    assert run.returncode != 0 or worst > ULPS


# ---------------------------------------------------------------------------
# the band-2 reflector pair (``pair_reflectors``), the same source's other
# kernel
# ---------------------------------------------------------------------------

# V's columns, τ and T within PAIR_EPS·ε of the largest entry of the plain
# version's piece: the six sums run in another order, and the second
# column's, orthogonalized by CholeskyQR2, carries its Gram products'
# rounding into every entry
PAIR_EPS = 16
PAIR_TYPES = {"f32": torch.float32, "f64": torch.float64}
# edits of the pair kernel that the cases must catch, and their type
PAIR_MUTANTS = {
    # the threads read g of step 4 before thread 0 has set it
    "pair_dropped_barrier": ("  }\n  __syncthreads();\n  const R g = shift;\n",
                             "  }\n  const R g = shift;\n", "f64"),
    # H0 applied with a1's pivot entry before CholeskyQR2
    "pair_raw_pivot": ("E::mul_rn(-beta0, b2(p))", "E::mul_rn(-beta0, a1(p))",
                       "f64"),
}


def test_a_cpu_tensor_takes_the_plain_pair():
    """On the CPU ``pair_reflectors`` is the plain version bit for bit,
    writes τ into ``tau_out``, and counts no launch of either kernel."""
    from _householder_cases import pair_cases

    before = dict(tk.LAUNCHES)
    for dtype in PAIR_TYPES.values():
        for _, m, c0, x in pair_cases(dtype, ms=(5, 40)):
            xt = torch.as_tensor(x, dtype=dtype)
            tau_out = torch.full((2,), float("nan"), dtype=dtype)
            got = tk.pair_reflectors(xt, c0, tau_out=tau_out)
            ref = tk._pair_reflectors_ref(xt, c0)
            assert got[1].data_ptr() == tau_out.data_ptr()
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and g.shape == r.shape
                assert g.numpy().tobytes() == r.numpy().tobytes()
    assert tk.LAUNCHES == before


@pytest.fixture(scope="module")
def pair_emu(tmp_path_factory):
    """csrc/householder.cu built against the stand-in runtime with
    pair_reflectors_main.cpp as its main: the source as it is and each
    mutant of PAIR_MUTANTS, compiled at once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    root = tmp_path_factory.mktemp("pair_emu")
    procs = {}
    for name in (None, *PAIR_MUTANTS):
        src = (REPO / "eigenexa_tpu_torch" / "csrc" /
               "householder.cu").read_text()
        if name is not None:
            old, new, _ = PAIR_MUTANTS[name]
            assert src.count(old) == 1, name
            src = src.replace(old, new)
        d = root / (name or "source")
        d.mkdir()
        (d / "kern.cpp").write_text(emulated(src))
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", f"-I{d}",
             "-Wno-unknown-pragmas", "-o", str(d / "emu"),
             str(emu / "pair_reflectors_main.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: root / (name or "source") / "emu" for name in procs}


def _run_pair_emu(binary, kind, tmp_path):
    """The pair cases of ``kind`` through the emulated kernel, x's rows
    three elements apart: (the run, the largest ``pair_error`` over the
    cases, the largest identity error over m + 4, whether every entry of
    V above its column's pivot is an exact zero).  In the parallel case
    the second reflector is left out of ``pair_error``: CholeskyQR2 leaves
    only rounding there, which the two versions round differently."""
    from _householder_cases import pair_cases, pair_error, pair_identity_error

    dtype = PAIR_TYPES[kind]
    np_type = NP[dtype]
    cases = pair_cases(dtype)
    src, dst = tmp_path / f"{kind}.in", tmp_path / f"{kind}.out"
    with open(src, "wb") as f:
        for _, m, c0, x in cases:
            f.write(np.array([m, c0 + 2, 3], np.int32).tobytes())
            rows = np.zeros((m, 3), np_type)
            rows[:, :2] = x
            rows[:, 2] = np.nan
            f.write(rows.tobytes())
    run = subprocess.run([str(binary), kind, str(src), str(dst)],
                         capture_output=True, text=True, timeout=120)
    buf = dst.read_bytes() if dst.exists() else b""
    size = np.dtype(np_type).itemsize
    worst, identity, zeros, off = 0.0, 0.0, True, 0
    for label, m, c0, x in cases:
        if off + (2 * m + 6) * size > len(buf):
            return run, np.inf, np.inf, False
        v = np.frombuffer(buf, np_type, 2 * m, off).reshape(m, 2)
        tau = np.frombuffer(buf, np_type, 2, off + 2 * m * size)
        t = np.frombuffer(buf, np_type, 4, off + (2 * m + 2) * size)
        off += (2 * m + 6) * size
        xt = torch.as_tensor(np.asarray(x, np_type))
        ref = [r.numpy() for r in tk._pair_reflectors_ref(xt, c0)]
        worst = max(worst, pair_error((v, tau, t.reshape(2, 2)), ref, dtype,
                                      second=label != "parallel"))
        identity = max(identity, pair_identity_error(
            xt.numpy(), c0, v, t.reshape(2, 2)) / (m + 4))
        zeros = zeros and not v[:c0 + 2, 0].any() and not v[:c0 + 3, 1].any()
    return run, worst, identity, zeros


@pytest.mark.parametrize("kind", list(PAIR_TYPES))
def test_pair_source_matches_the_plain_version_on_cpu_threads(
        pair_emu, kind, tmp_path):
    """The pair kernel of csrc/householder.cu, run as fibers on a CPU
    thread: every case within ``PAIR_EPS`` of the plain version, V exactly
    zero above each column's pivot, Hᵀ = I − V·Tᵀ·Vᵀ zeroing each column
    below its pivot within (m + 4)·ε of the column's norm, a rerun bitwise
    equal, x untouched and nothing written outside V's two columns, τ and
    T."""
    from _householder_cases import pair_cases

    run, worst, identity, zeros = _run_pair_emu(pair_emu[None], kind,
                                                tmp_path)
    assert run.returncode == 0, (run.stdout, run.stderr)
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL OK"
    assert len(lines) == len(pair_cases(PAIR_TYPES[kind])) + 1
    assert worst <= PAIR_EPS, worst
    assert identity <= 1 and zeros, (identity, zeros)


@pytest.mark.parametrize("mutant", list(PAIR_MUTANTS))
def test_pair_source_mutants_fail_on_cpu_threads(pair_emu, mutant, tmp_path):
    """The pair cases have teeth: threads that read g before the barrier
    take a value that is not yet set; H₀ applied with the pivot entry from
    before CholeskyQR2 leaves the second column unreduced."""
    kind = PAIR_MUTANTS[mutant][2]
    run, worst, identity, _ = _run_pair_emu(pair_emu[mutant], kind, tmp_path)
    assert run.returncode != 0 or worst > PAIR_EPS or identity > 1


# ---------------------------------------------------------------------------
# the band-2 pair's update (``pair_update``), the same source's third kernel
# ---------------------------------------------------------------------------

# W's new columns within UPDATE_EPS·√m·ε of the largest entry of the plain
# version's: the products' sums over the panel's columns and the m rows run
# in another order than the plain version's
UPDATE_EPS = 4
# edits of the update kernel that the cases must catch, and their type
UPDATE_MUTANTS = {
    # a block's rows read Wᵀ·V and Uᵀ·V before the slabs' sums are in
    "update_dropped_barrier": ("    cwu[e / 4][e % 4] = total;\n  }\n"
                               "  __syncthreads();\n",
                               "    cwu[e / 4][e % 4] = total;\n  }\n",
                               "f64"),
    # W = P − V·S, the half left out
    "update_no_half": ("E::mul_rn(R(0.5), x0)", "x0", "f64"),
}


def test_a_cpu_tensor_takes_the_plain_update():
    """On the CPU ``pair_update`` is the plain version bit for bit and
    counts no launch."""
    from _householder_cases import update_cases

    before = dict(tk.LAUNCHES)
    for dtype in PAIR_TYPES.values():
        for _, m, c0, j0, _, bv, u, w, v, t in update_cases(dtype, ms=(40,)):
            args = [torch.as_tensor(a, dtype=dtype) for a in (bv, u, w, v, t)]
            ref = [a.clone() for a in args]
            tk.pair_update(args[0], args[1], args[2], c0, args[3], args[4],
                           zero_rows=j0)
            tk._pair_update_ref(ref[0], ref[1], ref[2], c0, ref[3], ref[4],
                                zero_rows=j0)
            for g, r in zip(args, ref):
                assert g.numpy().tobytes() == r.numpy().tobytes()
    assert tk.LAUNCHES == before


@pytest.fixture(scope="module")
def update_emu(tmp_path_factory):
    """csrc/householder.cu built against the stand-in runtime with
    pair_update_main.cpp as its main: the source as it is and each mutant
    of UPDATE_MUTANTS, compiled at once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    root = tmp_path_factory.mktemp("update_emu")
    procs = {}
    for name in (None, *UPDATE_MUTANTS):
        src = (REPO / "eigenexa_tpu_torch" / "csrc" /
               "householder.cu").read_text()
        if name is not None:
            old, new, _ = UPDATE_MUTANTS[name]
            assert src.count(old) == 1, name
            src = src.replace(old, new)
        d = root / (name or "source")
        d.mkdir()
        (d / "kern.cpp").write_text(emulated(src))
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", f"-I{d}",
             "-Wno-unknown-pragmas", "-o", str(d / "emu"),
             str(emu / "pair_update_main.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: root / (name or "source") / "emu" for name in procs}


def _run_update_emu(binary, kind, tmp_path, ms=(5, 66, 1000)):
    """The update cases of ``kind`` with m in ``ms`` through the emulated
    kernel: (the run, the largest ``update_error`` over the cases)."""
    from _householder_cases import update_cases, update_error

    dtype = PAIR_TYPES[kind]
    np_type = NP[dtype]
    cases = [c for c in update_cases(dtype, ms) if c[1] in ms or c[1] == 40]
    src, dst = tmp_path / f"{kind}.in", tmp_path / f"{kind}.out"
    with open(src, "wb") as f:
        for _, m, c0, j0, ldu, bv, u, w, v, t in cases:
            f.write(np.array([m, c0, j0, ldu], np.int32).tobytes())
            for a in (bv, u, w, v, t):
                f.write(np.asarray(a, np_type).tobytes())
    run = subprocess.run([str(binary), kind, str(src), str(dst)],
                         capture_output=True, text=True, timeout=300)
    buf = dst.read_bytes() if dst.exists() else b""
    size = np.dtype(np_type).itemsize
    worst, off = 0.0, 0
    for _, m, c0, j0, ldu, bv, u, w, v, t in cases:
        if off + 2 * m * ldu * size > len(buf):
            return run, np.inf
        got_u = np.frombuffer(buf, np_type, m * ldu, off).reshape(m, ldu)
        got_w = np.frombuffer(buf, np_type, m * ldu,
                              off + m * ldu * size).reshape(m, ldu)
        off += 2 * m * ldu * size
        ref = [torch.as_tensor(np.asarray(a, np_type)).clone()
               for a in (bv, u, w, v, t)]
        tk._pair_update_ref(ref[0], ref[1], ref[2], c0, ref[3], ref[4],
                            zero_rows=j0)
        worst = max(worst, update_error(got_u, got_w, ref[1].numpy(),
                                        ref[2].numpy(), c0, dtype))
    return run, worst


@pytest.mark.parametrize("kind", list(PAIR_TYPES))
def test_update_source_matches_the_plain_version_on_cpu_threads(
        update_emu, kind, tmp_path):
    """The update kernel of csrc/householder.cu, run as fibers on a CPU
    thread: W's new columns within ``UPDATE_EPS`` of the plain version
    (zero before j0), U's new columns V's bits, every other entry of U and
    W untouched, a rerun bitwise equal, B·V, V and T untouched and nothing
    written past U or W."""
    from _householder_cases import update_cases

    run, worst = _run_update_emu(update_emu[None], kind, tmp_path)
    assert run.returncode == 0, (run.stdout, run.stderr)
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL OK"
    assert len(lines) == len(update_cases(PAIR_TYPES[kind])) + 1
    assert worst <= UPDATE_EPS, worst


@pytest.mark.parametrize("mutant", list(UPDATE_MUTANTS))
def test_update_source_mutants_fail_on_cpu_threads(update_emu, mutant,
                                                   tmp_path):
    """The update cases have teeth: a block's rows read before the slabs'
    column sums are added take sums that are not yet set; W without the
    half of V·S is another matrix."""
    kind = UPDATE_MUTANTS[mutant][2]
    run, worst = _run_update_emu(update_emu[mutant], kind, tmp_path,
                                 ms=(66,))
    assert run.returncode != 0 or worst > UPDATE_EPS
