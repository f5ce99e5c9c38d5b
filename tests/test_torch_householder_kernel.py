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

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _householder_cases import NP, reflector_cases, ulps  # noqa: E402

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
        src, count = re.subn(
            r"(householder_vector_kernel<E>)<<<1, kThreads, 0,\s*"
            r"static_cast<cudaStream_t>\(stream\)>>>\(\s*",
            r"emu_launch(\1, 1, kThreads, ", src)
        assert count == 1                  # one launch, every type
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
