"""Port kernels (eigenexa_tpu_torch/ops/kernels.py) against the JAX Pallas
kernels (eigenexa_tpu/ops/pallas_kernels.py).

On the CPU the port's wrappers run the plain PyTorch version; the JAX side
runs the real Pallas kernel body in interpret mode for f32 (f64 takes the
JAX package's own jnp path).  Tolerances: f32 atol 1e-4 as the JAX kernel
tests use (k ≤ 128 products of N(0,1) entries, f32 rounding in another
summation order); f64 rtol 1e-13 with atol 1e-13·max|ref| (only the
summation order differs, so entries that cancel to near zero keep an
absolute error of the size of the largest entry's rounding).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n_, rng, t  # noqa: E402

from eigenexa_tpu.ops import pallas_kernels as pk  # noqa: E402
from eigenexa_tpu_torch.ops import kernels as tk  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(256, 256, 128), (64, 128, 64), (8, 128, 7), (24, 384, 100)]


def _assert_close(out, ref, dtype, f32_tol=1e-4):
    out, ref = n_(out), n_(ref)
    if dtype == np.float32:
        np.testing.assert_allclose(out, ref, atol=f32_tol, rtol=f32_tol)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max())


def _randn(seed, *shape, dtype=np.float64):
    return rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_sub_matmul_matches_jax(m, n, k, dtype):
    b, p, q = (_randn(s, *sh, dtype=dtype)
               for s, sh in ((10, (m, n)), (11, (m, k)), (12, (n, k))))
    ref = pk.sub_matmul(jnp.asarray(b), jnp.asarray(p), jnp.asarray(q),
                        interpret=True)
    _assert_close(tk.sub_matmul(t(b), t(p), t(q)), ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rank2k_update_matches_jax(dtype):
    b, u, w = (_randn(s, *sh, dtype=dtype)
               for s, sh in ((20, (256, 256)), (21, (256, 64)),
                             (22, (256, 64))))
    ref = pk.rank2k_update(jnp.asarray(b), jnp.asarray(u), jnp.asarray(w),
                           interpret=True)
    _assert_close(tk.rank2k_update(t(b), t(u), t(w)), ref, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wy_apply_matches_jax(dtype):
    # the JAX kernel test's WY block: unit-lower V, small upper T
    z = _randn(30, 256, 128, dtype=dtype)
    v = (np.tril(_randn(31, 256, 64), -1) + np.eye(256, 64)).astype(dtype)
    tt = (np.triu(_randn(32, 64, 64)) * 0.1).astype(dtype)
    ref = pk.wy_apply(jnp.asarray(z), jnp.asarray(v), jnp.asarray(tt),
                      interpret=True)
    # f32: the T·VᵀZ chain grows entries to O(10); 1e-3 as the JAX test
    _assert_close(tk.wy_apply(t(z), t(v), t(tt)), ref, dtype, f32_tol=1e-3)


def test_sub_matmul_in_place_on_a_view():
    big = _randn(40, 96, 96)
    p, q = _randn(41, 80, 16), _randn(42, 80, 16)
    want = big.copy()
    want[16:, 16:] -= p @ q.T
    tb = t(big)
    view = tb[16:, 16:]
    out = tk.sub_matmul(view, t(p), t(q), out=view)
    assert out.data_ptr() == view.data_ptr()
    np.testing.assert_allclose(n_(tb), want, rtol=1e-13, atol=1e-13)


def test_sub_matmul_complex_conjugates_on_cpu():
    r = rng(3)
    b, p, q = ((r.standard_normal(s) + 1j * r.standard_normal(s))
               for s in ((32, 128), (32, 16), (128, 16)))
    out = tk.sub_matmul(t(b), t(p), t(q))
    np.testing.assert_allclose(n_(out), b - p @ np.conj(q).T, rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("m,n,k", [(40, 33, 1), (17, 70, 5), (64, 48, 130)])
def test_complex_sub_matmul_matches_jax(m, n, k, dtype):
    """B − P·Qᴴ on c64/c128 against the JAX package's sub_matmul (its
    complex path, ``b - p @ conj(q).T``): ragged shapes, k = 1, 5, 130,
    and in place on a strided view of a larger matrix, as the rolled
    Hermitian reduction calls it.  Tolerance: c64 1e-4 (sums of k ≤ 130
    products of N(0,1) entries in another order), c128 as f64."""
    r = rng(50 + k)
    big, p, q = ((r.standard_normal(s) + 1j * r.standard_normal(s))
                 .astype(dtype) for s in ((m + 7, n + 9), (m, k), (n, k)))
    b = big[7:, 9:]
    ref = n_(pk.sub_matmul(jnp.asarray(b), jnp.asarray(p), jnp.asarray(q),
                           interpret=True))
    tol = 1e-4 if dtype == np.complex64 else None
    _assert_close(tk.sub_matmul(t(b), t(p), t(q)), ref,
                  np.float32 if tol else np.float64)
    tb = t(big)
    view = tb[7:, 9:]
    out = tk.sub_matmul(view, t(p), t(q), out=view)
    assert out.data_ptr() == view.data_ptr()
    _assert_close(view, ref, np.float32 if tol else np.float64)
    np.testing.assert_array_equal(n_(tb)[:7], big[:7])
    np.testing.assert_array_equal(n_(tb)[:, :9], big[:, :9])


def test_cpu_tensors_never_count_launches():
    before = dict(tk.LAUNCHES)
    b, p, q = t(_randn(1, 64, 64)), t(_randn(2, 64, 8)), t(_randn(3, 64, 8))
    tk.sub_matmul(b, p, q)
    tk.sub_matmul(b, p, q, out=b)
    tk.rank2k_update(b, p, q)
    tk.pair_reflectors(p[:, :2], 0)
    tk.pair_update(p[:, :2], b[:, :8], b[:, 8:16], 2, q[:, :2], b[:2, :2])
    tk.column_update(p[:, 0], b[:, :8], b[:, 8:16], 2, q[:, 0], b[0, 0])
    tk.wy_apply(b, p, t(_randn(4, 8, 8)))
    tk.symv_lower(b, p[:, 0])
    tk.symv_lower(b, p[:, :2])
    tk.rank2k_update_window(b, p, q)
    d, e = b.diagonal(), b.diagonal(-1)
    ends = torch.full((64,), -1e3, dtype=b.dtype), torch.full((64,), 1e3)
    tk.sturm_bisect(d, e, None, *ends, 3)
    tk.sturm_bisect(d, e, e[:-1], *ends, 3, check_valid=True, w0=d)
    assert tk.LAUNCHES == before
    assert set(before) == {"sub_matmul", "symv_lower",
                           "rank2k_update_window", "sturm_bisect",
                           "householder_vector", "column_update",
                           "pair_reflectors", "pair_update"}


def test_wrapper_rejects_bad_operands_and_unknown_devices():
    b, p, q = t(_randn(1, 8, 6)), t(_randn(2, 8, 3)), t(_randn(3, 5, 3))
    with pytest.raises(ValueError):
        tk.sub_matmul(b, p, q)                       # Q rows != B cols
    with pytest.raises(TypeError):
        tk.sub_matmul(b, p.float(), t(_randn(3, 6, 3)))
    # a device that is neither CPU nor CUDA has no plain fallback
    mb, mp, mq = (torch.empty(s, device="meta")
                  for s in ((8, 6), (8, 3), (6, 3)))
    with pytest.raises(NotImplementedError):
        tk.sub_matmul(mb, mp, mq)


def _c_code(path: Path) -> str:
    """A CUDA source without its // comments."""
    return "\n".join(line.split("//")[0]
                     for line in path.read_text().splitlines())


def test_build_table_binds_every_entry_point():
    """Every extern "C" function of every source under csrc/ is built and
    gets its argument types (ctypes would otherwise cut a pointer to 32
    bits), with one c_void_p or integer per C parameter."""
    import ctypes
    import re

    from eigenexa_tpu_torch.ops import _build

    csrc = REPO / "eigenexa_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(
        _build._SOURCES)
    found = {}
    for src in _build._SOURCES:
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', _c_code(csrc / src)):
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    bound = dict(_build.entry_points())
    # f32 and f64 of the three matmul and matvec entry points, c64 and c128
    # of the whole-matrix subtract-product; the Sturm recurrence is f64 only;
    # the reflector in all four types; the reflector pair and its update,
    # and the column's update, in f32 and f64
    assert set(found) == set(bound) and len(found) == 19
    assert "eigenexa_sturm_bisect_f64" in found
    assert {"eigenexa_sub_matmul_c64", "eigenexa_sub_matmul_c128"} <= set(
        found)
    assert {f"eigenexa_householder_vector_{s}"
            for s in ("f32", "f64", "c64", "c128")} <= set(found)
    assert {"eigenexa_pair_reflectors_f32", "eigenexa_pair_reflectors_f64",
            "eigenexa_pair_update_f32", "eigenexa_pair_update_f64",
            "eigenexa_column_update_f32",
            "eigenexa_column_update_f64"} <= set(found)
    for name, params in found.items():
        assert len(params) == len(bound[name]), name
        for param, ctype in zip(params, bound[name]):
            want = (ctypes.c_void_p if "*" in param else
                    ctypes.c_longlong if param.startswith("long long")
                    else ctypes.c_int)
            assert ctype is want, (name, param)


def test_symv_scratch_is_sized_for_the_kernels_tile():
    """The wrapper allocates one scratch slot per (source tile, vector,
    row); its tile edge must be the kernel's."""
    import re

    src = _c_code(REPO / "eigenexa_tpu_torch" / "csrc" / "symv_lower.cu")
    (tile,) = re.findall(r"constexpr int kTile = (\d+);", src)
    assert int(tile) == tk._SYMV_TILE


def _fake_nvcc(tmp_path, fail_on=None):
    """An nvcc stand-in that logs its arguments and creates its -o file."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        + (f'case "$*" in *{fail_on}*) echo "boom in {fail_on}" >&2; '
           "exit 3;; esac\n" if fail_on else "")
        + 'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; '
        "shift; done\n")
    fake.chmod(0o755)
    return fake, log


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    from eigenexa_tpu_torch.ops import _build

    fake, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_seconds", None)
    target = tmp_path / "out" / "abc" / _build._LIB_NAME
    _build._build(target)
    assert target.exists() and _build.build_seconds > 0
    assert [p.name for p in target.parent.iterdir()] == [_build._LIB_NAME]
    lines = log.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    links = [ln for ln in lines if " -shared " in ln]
    assert len(compiles) == len(_build._SOURCES) and len(links) == 1
    assert lines[-1] == links[0]                  # the link comes last
    for src in _build._SOURCES:
        assert sum(ln.endswith(src) for ln in compiles) == 1
        assert src.replace(".cu", ".o") in links[0]
    assert all("code=sm_90a" in ln for ln in lines)


def test_build_failure_raises_with_nvccs_output(tmp_path, monkeypatch):
    from eigenexa_tpu_torch.ops import _build

    fake, log = _fake_nvcc(tmp_path, fail_on="symv_lower.cu")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_seconds", None)
    target = tmp_path / "out" / "abc" / _build._LIB_NAME
    with pytest.raises(RuntimeError, match="boom in symv_lower.cu"):
        _build._build(target)
    assert not target.exists() and _build.build_seconds is None
    assert " -shared " not in log.read_text()     # nothing was linked
    assert list(target.parent.iterdir()) == []    # and nothing left behind


def test_resource_usage_asks_ptxas_once_per_source(tmp_path, monkeypatch):
    from eigenexa_tpu_torch.ops import _build

    fake, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path / "out")
    text = _build.resource_usage()
    lines = log.read_text().splitlines()
    assert len(lines) == len(_build._SOURCES)
    for src in _build._SOURCES:
        assert f"resource usage of {src}" in text
        assert sum(ln.endswith(src) and "--resource-usage" in ln
                   and "code=sm_90a" in ln for ln in lines) == 1
    assert list((tmp_path / "out").iterdir()) == []   # nothing is kept


def test_kernel_sums_use_no_atomics():
    """The bitwise-repeat contract: no kernel adds across blocks with
    atomics, whose order changes from run to run."""
    for path in (REPO / "eigenexa_tpu_torch" / "csrc").glob("*.cu"):
        assert "atomic" not in _c_code(path).lower(), path


@pytest.mark.parametrize("word", ["mma", "wgmma", "tf32", "atomic"])
def test_sub_matmul_source_keeps_the_full_precision_contract(word):
    """csrc/sub_matmul.cu promises a full-precision product with a sum in
    one order: its code (comments stripped) names no warpgroup
    tensor-core instruction, no TF32 conversion and no atomic.  Its
    tensor-core instructions are DMMA, full IEEE f64, of depth 4: every
    `mma` in the code is `mma.sync.aligned.m8n8k4...f64` or, for the c128
    ring kernel, `mma.sync.aligned.m16n8k4...f64` (two m8n8k4 on one B),
    and the f32 and c64 kernels name none."""
    import re

    src = _c_code(REPO / "eigenexa_tpu_torch" / "csrc" / "sub_matmul.cu")
    assert "sub_matmul_kernel_f32_128" in src
    if word != "mma":
        assert word not in src.lower()
        return
    found = re.findall(r"\w*mma[\w.]*", src)
    instr = [w for w in found if "." in w]
    assert instr == ["mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64",
                     "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64"]
    assert set(found) - set(instr) == {"dmma_m8n8k4", "dmma_m16n8k4",
                                       "sub_matmul_kernel_f64_dmma"}
    for kernel in ("sub_matmul_kernel(", "sub_matmul_kernel_f32_128(",
                   "sub_matmul_kernel_c64(", "sub_matmul_kernel_c64_wide("):
        body = src[src.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert "mma" not in body, kernel
    ring = src[src.index("sub_matmul_kernel_c128_ring("):]
    ring = ring[:ring.index("\n}\n")]
    assert "dmma_m16n8k4" in ring and "dmma_m8n8k4" not in ring


# edits of csrc/sub_matmul.cu that the emulated complex kernels must catch,
# with the SM counts whose launch rules reach the kernels that must fail
# (132: the 64-tile kernels at the emulator's sizes; 1: the larger-tile ones)
SUB_MATMUL_MUTANTS = {
    # the conjugate of Q dropped, in the one helper every kernel takes it by
    "conj_dropped": ("imaginary ? -x : x", "x", (132, 1)),
    # the wait that lands a slice of the c128 ring before the slice is read
    "dropped_ring_wait": ("    cp_async_wait<kZ2Stages - 2>();\n", "",
                          (1,)),
}


def _emu_async(src: str, copies: int) -> str:
    """The inline PTX of cp.async (copies, commit, wait) and the dynamic
    shared memory of a CUDA source rewritten into the stand-in's calls;
    `copies` counts the copy helpers (one for each size)."""
    import re

    src, count = re.subn(
        r'asm volatile\("cp\.async\.\w+\.shared\.global \[%0\], \[%1\], '
        r'(\d+);\\n"\s*::\s*"r"\(smem_u32\((\w+)\)\),\s*"l"\((\w+)\)\);',
        r"emu_cp_async(\2, \3, \1);", src)
    assert count == copies
    src, count = re.subn(r'asm volatile\("cp\.async\.commit_group;\\n"[^;]*;',
                         "emu_cp_async_commit();", src)
    assert count == 1
    src, count = re.subn(
        r'asm volatile\("cp\.async\.wait_group %0;\\n"\s*::\s*"n"\((\w+)\)'
        r'[^;]*;', r"emu_cp_async_wait(\1);", src)
    assert count == 1
    src, count = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
        r"unsigned char* const \1 = emu_dynamic_smem;", src)
    assert count == 1
    return src


@pytest.fixture(scope="module")
def emu_binaries(tmp_path_factory):
    """csrc/sub_matmul.cu built by the host compiler against the stand-in
    runtime of tests/cuda_emu: the launches, the inline PTX (DMMA and the
    c128 ring's cp.async) and the dynamic shared memory rewritten into the
    stand-in's calls, with sub_matmul_main.cpp as its main; the source as
    it is and each mutant of SUB_MATMUL_MUTANTS, compiled at once."""
    import re
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    src = (REPO / "eigenexa_tpu_torch" / "csrc" / "sub_matmul.cu").read_text()
    src, count = re.subn(
        r"(sub_matmul_kernel\w*)<<<(\w+), kThreads, (?:0|kZ2Bytes),\s*s>>>"
        r"\(\s*", r"emu_launch(\1, \2, kThreads, ", src)
    assert count == 7                      # one launch for each kernel
    src, count = re.subn(
        r'asm volatile\("mma\.sync\.aligned\.m8n8k4.*?:\s*"\+d"\((.+?)\),'
        r'\s*"\+d"\((.+?)\)\s*:\s*"d"\((.+?)\),\s*"d"\((.+?)\)\);',
        r"emu_dmma_m8n8k4(\1, \2, \3, \4);", src, flags=re.S)
    assert count == 1
    src, count = re.subn(
        r'asm volatile\("mma\.sync\.aligned\.m16n8k4.*?:\s*'
        + r',\s*'.join([r'"\+d"\((.+?)\)'] * 4) + r'\s*:\s*'
        + r',\s*'.join([r'"d"\((.+?)\)'] * 3) + r'\);',
        r"emu_dmma_m16n8k4(\1, \2, \3, \4, \5, \6, \7);", src, flags=re.S)
    assert count == 1
    src = _emu_async(src, copies=1)
    assert "asm" not in src
    tmp_path = tmp_path_factory.mktemp("emu")
    procs = {}
    for name in (None, *SUB_MATMUL_MUTANTS):
        text = src
        if name is not None:
            old, new, _ = SUB_MATMUL_MUTANTS[name]
            assert text.count(old) == 1, name
            text = text.replace(old, new)
        d = tmp_path / (name or "base")
        d.mkdir()
        (d / "kern.cpp").write_text(text)
        shutil.copy(emu / "sub_matmul_main.cpp", d)
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", "-Wno-unknown-pragmas",
             "-o", "emu", "sub_matmul_main.cpp"],
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: tmp_path / (name or "base") / "emu" for name in procs}


@pytest.fixture(scope="module")
def emu_binary(emu_binaries):
    return emu_binaries[None]


# the emulator main's argument for each kernel, and the lines it prints: one
# a case and the verdict
EMU_RUNS = {"the 128-tile kernel": ("f32", 17),
            "the 64-tile kernel": ("f32", 17),
            "the f64 DMMA kernel": ("f64", 11),
            "the c64 kernel": ("c64", 9),
            "the c128 DMMA kernel": ("c128", 9)}


@pytest.mark.parametrize("sms,kernel", [(1, "the 128-tile kernel"),
                                        (10 ** 6, "the 64-tile kernel"),
                                        (1, "the f64 DMMA kernel"),
                                        (1, "the c64 kernel"),
                                        (1, "the c128 DMMA kernel"),
                                        (10 ** 6, "the c64 kernel"),
                                        (10 ** 6, "the c128 DMMA kernel")])
def test_sub_matmul_source_gives_the_fma_chain_bits_on_cpu_threads(
        emu_binary, sms, kernel):
    """csrc/sub_matmul.cu itself, run as fibers on a CPU thread (see
    `emu_binary`): every output equals, bit for bit, one chain of fma over
    k then b - acc, at aligned, ragged, odd-stride, offset, in-place and
    window cases with k = 0 ... 132, and nothing outside the view is
    written.  In f32 the stand-in reports `sms` SMs, which sends every
    launch to one kernel of the launch rule: both give the same bits.
    Every f64 launch takes the DMMA kernel, whose inline PTX becomes the
    stand-in's fragment exchange.  The complex kernels give, bit for bit,
    the two real fma chains of B − P·Qᴴ (re over pr·qr, pi·qi; im over
    pi·qr, −pr·qi; l ascending) on a tile, ragged edges, in-place strided
    and offset views, k = 0, 1, 5 and 130: with 1 SM every complex launch
    takes the larger-tile kernel of its type (c64 64×128 tiles on the FMA
    path, c128 the cp.async ring on the stand-in's DMMA), with 10⁶ the
    64-tile kernel."""
    arg, lines = EMU_RUNS[kernel]
    run = subprocess.run([str(emu_binary), arg],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, EMU_SMS=str(sms)))
    assert run.returncode == 0, (kernel, run.stdout, run.stderr)
    out = run.stdout.splitlines()
    assert out[-1] == "ALL OK" and len(out) == lines


@pytest.mark.parametrize("mutant,dtype", [("conj_dropped", "c64"),
                                          ("conj_dropped", "c128"),
                                          ("dropped_ring_wait", "c128")])
def test_complex_sub_matmul_mutants_fail_on_cpu_threads(emu_binaries,
                                                        mutant, dtype):
    """A copy of the source with Q's conjugate dropped fails the complex
    cases of every kernel of both launch rules; one without the c128
    ring's wait reads slices before their copies land, and fails."""
    for sms in SUB_MATMUL_MUTANTS[mutant][2]:
        run = subprocess.run([str(emu_binaries[mutant]), dtype],
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, EMU_SMS=str(sms)))
        assert (run.returncode != 0
                and run.stdout.splitlines()[-1] == "FAIL"), (
            mutant, sms, run.stdout)


SYMV_MUTANTS = {
    # the wait that lands a tile's copies before the tile is read
    "dropped_wait": ("    cp_async_wait<kS - 2>();\n", ""),
    # the last tile of every block
    "dropped_last_tile": ("for (int k = 0; k < count; ++k) {",
                          "for (int k = 0; k + 1 < count; ++k) {"),
}


def _symv_emu_source(mutant=None) -> str:
    """csrc/symv_lower.cu rewritten for the stand-in runtime: the two
    launches, the inline PTX of cp.async (copies, commit, wait) and the
    dynamic shared memory; `mutant` names an edit of SYMV_MUTANTS."""
    import re

    src = (REPO / "eigenexa_tpu_torch" / "csrc" / "symv_lower.cu").read_text()
    if mutant is not None:
        old, new = SYMV_MUTANTS[mutant]
        assert src.count(old) == 1, mutant
        src = src.replace(old, new)
    src, count = re.subn(
        r"(symv_\w+_kernel<[^>]*>)<<<(\w+), ([^,]+), .*?, stream>>>\(\s*",
        r"emu_launch(\1, \2, \3, ", src, flags=re.S)
    assert count == 2                      # one launch for each pass
    src = _emu_async(src, copies=3)        # 16-, 8- and 4-byte copies
    assert "asm" not in src
    return src


@pytest.fixture(scope="module")
def symv_emu(tmp_path_factory):
    """csrc/symv_lower.cu built by the host compiler against the stand-in
    runtime of tests/cuda_emu, with symv_main.cpp as its main: the source
    as it is, and each mutant of SYMV_MUTANTS, all compiled at once."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    root = tmp_path_factory.mktemp("symv_emu")
    procs = {}
    for name in (None, *SYMV_MUTANTS):
        d = root / (name or "source")
        d.mkdir()
        (d / "kern.cpp").write_text(_symv_emu_source(name))
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", f"-I{d}",
             "-Wno-unknown-pragmas", "-o", str(d / "emu"),
             str(emu / "symv_main.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: root / (name or "source") / "emu" for name in procs}


def _run_symv_emu(binary, dtype: str, sms: int):
    return subprocess.run([str(binary), dtype], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, EMU_SMS=str(sms)))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_symv_source_matches_a_plain_loop_on_cpu_threads(symv_emu, dtype):
    """csrc/symv_lower.cu itself, run as fibers on a CPU thread (see
    `symv_emu`): at aligned, ragged, odd-stride, offset, strided-X, 1 to 8
    vector cases, with and without the fused panel (one wider than 64
    columns), every row within the
    summation-order bound of a long-double loop, zeros above the window,
    nothing written past Q or the scratch, and a rerun on the reused
    scratch bitwise equal.  With 2 and with 5 SMs the persistent grid
    deals the tiles out otherwise; the bits must not move."""
    runs = [_run_symv_emu(symv_emu[None], dtype, sms) for sms in (2, 5)]
    for run in runs:
        assert run.returncode == 0, (run.stdout, run.stderr)
        lines = run.stdout.splitlines()
        assert lines[-1] == "ALL OK" and len(lines) == 14
    assert runs[0].stdout == runs[1].stdout


@pytest.mark.parametrize("mutant", list(SYMV_MUTANTS))
def test_symv_source_mutants_fail_on_cpu_threads(symv_emu, mutant):
    """The stand-in has teeth: without the wait, a tile is read before its
    copies land; without a block's last tile, rows lose a term."""
    run = _run_symv_emu(symv_emu[mutant], "f32", 3)
    assert run.returncode != 0 and run.stdout.splitlines()[-1] == "FAIL"


# name: (text of csrc/sturm.cu, its replacement, the cases that must differ:
# the mutant runs only the cases whose name holds this text)
STURM_MUTANTS = {
    # the band-1 clamp of a pivot that meets zero
    "dropped_pivmin_band1": ("        if (fabs(q) < pivmin) q = -pivmin;\n",
                             "", "exact zeros"),
    # the band-2 clamp
    "dropped_pivmin_band2": (
        "fabs(a) < pivmin ? (a >= 0.0 ? pivmin : -pivmin) : a;", "a;",
        "exact zeros"),
    # each probe straight from the bracket, a + k (b - a) / 2^L with k the
    # node's rank in order: the same points in exact arithmetic, other
    # roundings than the midpoints of a walk
    "direct_probes": (
        "heap_probe(sub, a, b)",
        "(a + double((2 * (sub - (1 << (31 - __builtin_clz(sub)))) + 1)"
        " << (levels - 1 - (31 - __builtin_clz(sub))))"
        " * ((b - a) / (1 << levels)))", "refine"),
    # the heap walk steps to the other child than its ballot bit says
    "wrong_child": ("node = 2 * node + !lower;", "node = 2 * node + lower;",
                    "n_iter"),
}


@pytest.fixture(scope="module")
def sturm_emu(tmp_path_factory):
    """csrc/sturm.cu built by the host compiler against the stand-in
    runtime of tests/cuda_emu, with sturm_main.cpp as its main: the source
    as it is, and each mutant of STURM_MUTANTS, all compiled at once."""
    import re
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    emu = REPO / "tests" / "cuda_emu"
    root = tmp_path_factory.mktemp("sturm_emu")
    procs = {}
    for name in (None, *STURM_MUTANTS):
        src = (REPO / "eigenexa_tpu_torch" / "csrc" / "sturm.cu").read_text()
        if name is not None:
            old, new, _ = STURM_MUTANTS[name]
            assert src.count(old) == 1, name
            src = src.replace(old, new)
        src, count = re.subn(
            r"(sturm_bisect_kernel<kBand2, kL>)<<<(\w+), kThreads, 0, s>>>"
            r"\(\s*", r"emu_launch(\1, \2, kThreads, ", src)
        assert count == 1                  # one launch, every band and L
        d = root / (name or "source")
        d.mkdir()
        (d / "kern.cpp").write_text(src)
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", f"-I{emu}", f"-I{d}",
             "-Wno-unknown-pragmas", "-o", str(d / "emu"),
             str(emu / "sturm_main.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err)
    return {name: root / (name or "source") / "emu" for name in procs}


def test_sturm_source_equals_the_plain_loop_on_cpu_threads(sturm_emu):
    """csrc/sturm.cu itself, run as fibers on a CPU thread (see
    `sturm_emu`): every case, band 1 and 2, n from 1 to 600, random and
    exact-zero bands, bisection and refinement, n_iter 1, 2, 7, 45 and 70
    (a short last round), through the entry point and through the launch
    of every L = 1 ... 5, bitwise equal to a plain loop over the raw bands,
    and nothing written past w."""
    run = subprocess.run([str(sturm_emu[None])], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, (run.stdout, run.stderr)
    lines = run.stdout.splitlines()
    assert lines[-1] == "ALL OK" and len(lines) == 58
    assert all("bitwise equal" in line for line in lines[:-1])


@pytest.mark.parametrize("mutant", list(STURM_MUTANTS))
def test_sturm_source_mutants_fail_on_cpu_threads(sturm_emu, mutant):
    """The cases have teeth: without a pivmin clamp a pivot of exactly 0
    turns the rest of an exact-zero case's recurrence into NaN; probes
    taken straight from the bracket round otherwise than the walk's
    midpoints; a walk that reads the other child's bit loses the index."""
    case = STURM_MUTANTS[mutant][2]
    run = subprocess.run([str(sturm_emu[mutant]), case],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout.splitlines()[-1] == "FAIL"
    assert any(case in line and "DIFFERS" in line
               for line in run.stdout.splitlines())


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["kernel", "same_bits", "symv",
                                   "rank2k_window", "sturm",
                                   "sturm_workers", "householder_vector",
                                   "pair_reflectors", "pair_update",
                                   "column_update"])
def test_chip_smoke_kernel_phases_pass_on_the_cpu(phase, monkeypatch):
    """The card script's kernel phases at small sizes on CPU tensors (the
    plain versions, nothing timed): every case builds its operands, views
    and bounds and passes its check, so a run on the card is not lost to
    the script."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    before = dict(tk.LAUNCHES)
    if phase == "kernel":
        rows = cs.kernel_phase(cpu, 256, timed=False, n_win=300, big=264,
                               rule=130)
        assert len(rows) == 2 * len(cs.kernel_cases(256, 300))
        assert {r["case"] for r in rows} >= {
            "wide_view", "odd_ld_view", "k5", "k132", "k130_of_132",
            "under_rule", "over_rule"}
    elif phase == "householder_vector":
        rows = cs.reflector_phase(cpu, timed=False)
        assert [(r["m"], r["dtype"]) for r in rows] == list(
            cs.REFLECTOR_CASES)
        assert all(r["rerun_bitwise_equal"] and r["max_ulps"] == 0
                   and r["launches"] == 0 for r in rows)
    elif phase == "pair_reflectors":
        rows = cs.pair_reflector_phase(cpu, timed=False)
        assert [(r["m"], r["dtype"]) for r in rows] == list(cs.PAIR_CASES)
        assert all(r["rerun_bitwise_equal"] and r["max_eps"] == 0
                   and r["launches"] == 0 for r in rows)
    elif phase == "pair_update":
        rows = cs.pair_update_phase(cpu, timed=False)
        assert [(r["m"], r["c0"], r["dtype"]) for r in rows] == list(
            cs.UPDATE_CASES)
        assert all(r["rerun_bitwise_equal"] and r["rest_kept"]
                   and r["max_eps_sqrt_m"] == 0 and r["launches"] == 0
                   for r in rows)
    elif phase == "column_update":
        rows = cs.column_update_phase(cpu, timed=False, n_solve=150)
        assert [(r["m"], r["j"], r["dtype"]) for r in rows] == [
            (m, j, dtype) for m, j, _, dtype in cs.COLUMN_CASES]
        assert all(r["rerun_bitwise_equal"] and r["rest_kept"]
                   and r["max_eps_sqrt_m"] == 0 and r["launches"] == 0
                   for r in rows)
    elif phase == "same_bits":
        rows = cs.same_bits_phase(cpu, big=264, block=64)
        assert len(rows) == 4
        assert {r["dtype"] for r in rows} == {"float32", "float64"}
    elif phase == "symv":
        full = cs.symv_cases(16384, 8192)
        assert [c[1:] for c in full["float64"] if "f64_path" in c[0]] == [
            (8192, 0, 1, False), (8192, 8, 1, False), (8192, 0, 1, True),
            (8192, 8, 1, True)]
        # the fused form at the windows of the f32 solve's groups
        assert [c[1:] for c in full["float32"] if c[4]] == [
            (16384, 0, 1, True), (16384, 16, 1, True), (16384, 28, 1, True)]
        # the band-2 pair pass at the first and the last panel's window
        assert [c[1:] for c in full["float32"] if c[0].startswith("sx_")] == [
            (8192, 0, 2, False), (8192, 14, 2, False), (16384, 28, 2, False)]
        assert [c[1:] for c in full["float64"] if c[0].startswith("sx_")] == [
            (8192, 0, 2, False), (8192, 14, 2, False)]
        cases = [("first_column", 700, 0, 1, False),
                 ("window", 700, 1, 1, False), ("pair", 700, 0, 2, False),
                 ("ragged", 637, 1, 1, False),
                 ("fused_window", 700, 1, 1, True)]
        monkeypatch.setattr(cs, "symv_cases", lambda m, m64: {
            "float32": cases,
            "float64": cases + [("f64_path_window", m64, 1, 1, False),
                                ("fused_f64_path_first_column", m64, 0, 1,
                                 True)]})
        rows = cs.symv_phase(cpu, 700, timed=False, m_f64=600)
        assert len(rows) == 12
        assert sum(r["fused_panel_columns"] == cs.NB_F - 1
                   for r in rows) == 3
    elif phase in ("sturm", "sturm_workers"):
        # every index at the small n, a sample at the large one; with
        # workers, as on the card, the sample's plain runs go to a worker
        # process and their rows wait until sturm_host_checks
        host = None
        if phase == "sturm_workers":
            monkeypatch.setitem(sys.modules, "chip_smoke", cs)
            host = cs.host_workers(1)
        try:
            rows = cs.sturm_phase(cpu, 40, 90, timed=False, samples=8,
                                  host=host)
            assert sum("pending" in r for r in rows) == (4 if host else 0)
            cs.sturm_host_checks(rows)
        finally:
            if host is not None:
                host.shutdown(wait=True, cancel_futures=True)
        assert [(r["n"], r["case"], r["indices_checked"]) for r in rows] == [
            (n, f"{op}_band{b}", k) for n, k in ((40, 40), (90, 8))
            for b in (1, 2) for op in ("bisect", "refine")]
        assert all(r["bitwise_equal"] and r["failed_bracket_keeps_w0"]
                   for r in rows)
    else:
        names = {dtype: [c[0] for c in cases] for dtype, cases in
                 cs.rank2k_window_cases(16384, 8192).items()}
        assert names["float32"] == [
            "first_panel", "window", "ragged", "ragged_large",
            "odd_ld_large"]
        assert names["float64"] == names["float32"] + [
            "f64_path_first_panel", "f64_path_window"]
        cases = [("first_panel", 700, 0), ("window", 700, 1),
                 ("ragged", 637, 1), ("odd_ld_large", 701, 1)]
        monkeypatch.setattr(cs, "rank2k_window_cases", lambda m, m64: {
            "float32": cases,
            "float64": cases + [("f64_path_window", m64, 1)]})
        rows = cs.rank2k_window_phase(cpu, 700, timed=False, m_f64=600)
        assert len(rows) == 9
        assert all(r["outside_untouched"] for r in rows)
    # the Sturm rows have no bound: they must give the plain version's bits
    assert all(r["max_abs_err"] <= r.get("bound", 0.0) for r in rows)
    assert tk.LAUNCHES == before


def test_chip_smoke_f64_phase_passes_on_the_cpu(monkeypatch):
    """The card script's f64 phase at Frank n = 200 on the CPU (the plain
    versions): rolled cold and warm, bitwise equal, then windowed; every
    check passes, and no kernel is launched."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "expected_launches", lambda n: 0)
    monkeypatch.setattr(cs, "reflectors", lambda n: 0)
    monkeypatch.setattr(cs, "columns", lambda n: 0)
    monkeypatch.setattr(cs, "expected_launches_windowed", lambda n: {
        name: 0 for name in tk.LAUNCHES})
    rolled, windowed = cs.f64_phase(torch.device("cpu"), 200)
    zeros = dict.fromkeys(tk.LAUNCHES, 0)
    assert rolled == zeros and windowed == zeros


def test_chip_smoke_trd_profile_reads_the_spans_on_the_cpu(monkeypatch,
                                                           capsys):
    """``--trd-profile`` at Frank n = 150 on the CPU: a line for each
    driver and reduction, with the span counts of the program's own
    ``trd.column`` / ``prd.pair`` spans and no kernel (CPU tensors launch
    none)."""
    monkeypatch.syspath_prepend(str(REPO))
    cs = _chip_smoke()
    cs.trd_profile(torch.device("cpu"), 150)
    heads = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("trd-profile: eigen")]
    assert [line.split()[1:3] for line in heads] == [
        ["eigen_s", "rolled"], ["eigen_s", "windowed"],
        ["eigen_sx", "rolled"], ["eigen_sx", "windowed"],
        ["eigen_h", "rolled"]]
    assert all("kernels 0.00 a" in line for line in heads)
    assert [line.split("(")[-1].split()[0] for line in heads] == [
        "150", "150", "76", "76", "150"]


def test_chip_smoke_complex_kernel_phase_passes_on_the_cpu():
    """The card script's complex sub_matmul phase at small sizes on CPU
    tensors: every case, the first rolled panel in place on its strided
    view included, passes its check, and the row-block call stays within
    the bound.  The rows name the kernel that the launch rule gives them
    (with an H100's 132 SMs for a CPU tensor)."""
    cs = _chip_smoke()
    before = dict(tk.LAUNCHES)
    rows = cs.complex_kernel_phase(torch.device("cpu"), 256, timed=False,
                                   block=64, ragged=(300, 277), rule=130)
    assert [(r["case"], r["dtype"]) for r in rows] == [
        (case, dtype) for dtype in ("complex64", "complex128")
        for case in ("rank2k", "wy", "dist_block", "ragged_k5",
                     "ragged_k130", "under_rule", "over_rule",
                     "same_bits_rank2k")]
    assert rows[0]["m"] == 192 and rows[4]["k"] == 130
    assert rows[2]["m"] == cs.N_DIST // 2
    assert [r["m"] for r in rows[5:7]] == [129, 130]
    assert all(r["max_abs_err"] <= r["bound"] for r in rows)
    assert {r.get("kernel") for r in rows} == {"c64", "c128", None}
    assert rows[7]["kernels"] == ["c64", "c64"]
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_chip_smoke_mirrors_the_complex_launch_rules(dtype):
    """chip_smoke.COMPLEX_RULE is csrc/sub_matmul.cu's complex launch rule
    (the tile whose count it holds against the SMs, and the factor), so the
    card script's
    cases land on the kernels it names: at an H100's 132 SMs the rank-2k
    call of n = 8192 takes the larger-tile kernel, its row blocks the
    64-tile one,
    and the rule squares fall on either side."""
    import re

    cs = _chip_smoke()
    src = _c_code(REPO / "eigenexa_tpu_torch" / "csrc" / "sub_matmul.cu")
    consts = {name: int(value) for name, value in re.findall(
        r"constexpr (?:int|long long) (\w+) = (\d+);", src)}
    # the launch rules in source order: f32, c64, c128
    rules = re.findall(r"fills_sms\(m, n, (\w+), (\w+), (\w+)\)", src)
    assert len(rules) == 3
    rule = rules[{"complex64": 1, "complex128": 2}[dtype]]
    assert cs.COMPLEX_RULE[dtype] == tuple(consts[name] for name in rule)
    big, small = {"complex64": ("c64_wide", "c64"),
                  "complex128": ("c128_ring", "c128")}[dtype]
    assert cs.complex_kernel_of(dtype, 8128, 8128, 132) == big
    block = cs.complex_block_rows(dtype, 8128, 132)
    assert block % 8 == 0 and block >= 64
    assert cs.complex_kernel_of(dtype, block, 8128, 132) == small
    assert cs.complex_kernel_of(dtype, block + 8, 8128, 132) == big
    rule = cs.complex_rule_square(dtype, 132)
    assert cs.complex_kernel_of(dtype, rule - 1, rule - 1, 132) == small
    assert cs.complex_kernel_of(dtype, rule, rule, 132) == big


def test_chip_smoke_hermitian_and_gev_phases_pass_on_the_cpu(monkeypatch):
    """The card script's hermitian and gev phases at n = 130 (modes at 100)
    on the CPU: every check of both dtypes and all modes passes, cold and
    warm solves are bitwise equal, and no kernel is launched."""
    cs = _chip_smoke()
    zeros = dict.fromkeys(tk.LAUNCHES, 0)
    monkeypatch.setattr(cs, "_want", lambda **counts: dict(zeros))
    cpu = torch.device("cpu")
    assert cs.hermitian_phase(cpu, 130, 100) == (zeros, zeros)
    assert cs.gev_phase(cpu, 130) == (zeros, zeros)


def test_import_runs_no_nvcc(tmp_path):
    """Importing every module of the port builds nothing: a fake nvcc on
    PATH and CUDA_HOME would leave a marker if anything ran it."""
    marker = tmp_path / "nvcc_ran"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "nvcc"
    fake.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    fake.chmod(0o755)
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "eigenexa_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "from eigenexa_tpu_torch.ops import _build\n"
            "assert _build._lib is None and _build.build_seconds is None\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k in sys.modules)\n")
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               CUDA_HOME=str(tmp_path), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert not marker.exists()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = list((REPO / "eigenexa_tpu_torch").rglob("*.py"))
    # the walk covers the band-2 slice's modules and the kernels' bindings
    names = {str(p.relative_to(REPO / "eigenexa_tpu_torch")) for p in files}
    assert names >= {"ops/sturm.py", "ops/band.py", "solvers/dc_band.py",
                     "utils/stageio.py", "ops/kernels.py", "ops/_build.py"}
    # the card's tests and chip tools run where JAX is not installed
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py",
              REPO / "tests" / "test_torch_gpu.py",
              *(REPO / "tools").glob("*.py")]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "eigenexa_tpu"), (path, name)


def test_chip_smoke_large_phase_passes_on_the_cpu(monkeypatch):
    """The card script's large phase at Frank n = 200 on the CPU, with the
    D&C's chunk width lowered so that its two top levels are panel-chunked
    and the checks streamed in blocks: eigen_s twice (bitwise equal) and
    eigen_sx pass every check through "auto", which keeps a CPU tensor
    rolled, and no kernel is launched.  Then the windowed path's kernel
    cases at m = 700, as the phase adds them where the rule picks that
    path."""
    from eigenexa_tpu_torch.solvers import dc_band, dc_tree

    cs = _chip_smoke()
    zeros = dict.fromkeys(tk.LAUNCHES, 0)
    monkeypatch.setattr(cs, "_want", lambda **counts: dict(zeros))
    monkeypatch.setattr(cs, "expected_launches_sx",
                        lambda n, windowed: dict(zeros))
    monkeypatch.setattr(cs, "CHECK_CHUNK", 64)
    for mod in (dc_tree, dc_band):
        monkeypatch.setattr(mod, "_LEVEL_CHUNK_MIN", 128)
        monkeypatch.setattr(mod, "_LEVEL_CHUNK_PANEL", 32)
    cpu = torch.device("cpu")
    before = dict(tk.LAUNCHES)
    assert cs.large_phase(cpu, 200, eigh_sizes=()) == (
        zeros, zeros, {"eigen_s": "rolled", "eigen_sx": "rolled"})
    assert cs.large_window_kernels(cpu, {"eigen_s": "rolled",
                                         "eigen_sx": "rolled"}) == []
    rows = cs.large_window_kernels(cpu, {"eigen_s": "windowed",
                                         "eigen_sx": "windowed"}, m=700,
                                   timed=False)
    assert [r["case"] for r in rows] == [
        "large_fused_first_column", "large_sx_pair_first",
        "large_first_panel"]
    assert all(r["max_abs_err"] <= r["bound"] for r in rows)
    assert tk.LAUNCHES == before


def test_chip_smoke_dist_phase_passes_on_the_cpu(monkeypatch):
    """The card script's dist phase at small sizes with both meshes on
    gloo CPU ranks: every case's checks (eigen_sx's among them), reruns
    bitwise equal, the same w on every rank, the 2×2 mesh's w within the
    bounds of the 1×1 mesh's, and the four-driver dryrun at n = 32; then
    the entry phase.  CPU tensors launch nothing, so the launch counts are
    patched to 0."""
    cs = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)   # the ranks load it
    for name, value in (("N_SLICE", 96), ("N_DIST", 64), ("N_DIST_H", 64),
                        ("N_DRYRUN", 32), ("DIST_TIMEOUT", 120)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "DIST_MESHES", (((1, 1), "gloo"),
                                            ((2, 2), "gloo")))
    zeros = dict.fromkeys(tk.LAUNCHES, 0)
    monkeypatch.setattr(cs, "dist_launches", lambda *args: dict(zeros))
    monkeypatch.setattr(cs, "_want", lambda **counts: dict(zeros))
    assert cs.dist_phase(torch.device("cpu")) == dict.fromkeys(
        ("nccl_1x1", "gloo_2x2", "sx nccl_1x1", "sx gloo_2x2",
         "sx N gloo_2x2"), zeros)
    assert cs.entry_phase(torch.device("cpu")) == zeros
