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


def test_cpu_tensors_never_count_launches():
    before = dict(tk.LAUNCHES)
    b, p, q = t(_randn(1, 64, 64)), t(_randn(2, 64, 8)), t(_randn(3, 64, 8))
    tk.sub_matmul(b, p, q)
    tk.sub_matmul(b, p, q, out=b)
    tk.rank2k_update(b, p, q)
    tk.wy_apply(b, p, t(_randn(4, 8, 8)))
    tk.symv_lower(b, p[:, 0])
    tk.symv_lower(b, p[:, :2])
    tk.rank2k_update_window(b, p, q)
    assert tk.LAUNCHES == before
    assert set(before) == {"sub_matmul", "symv_lower",
                           "rank2k_update_window"}


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
    bound = {name + sfx: args for name, args in _build._ARGTYPES.items()
             for sfx in ("_f32", "_f64")}
    assert set(found) == set(bound) and len(found) == 6
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


def test_kernel_sums_use_no_atomics():
    """The bitwise-repeat contract: no kernel adds across blocks with
    atomics, whose order changes from run to run."""
    for path in (REPO / "eigenexa_tpu_torch" / "csrc").glob("*.cu"):
        assert "atomic" not in _c_code(path).lower(), path


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
    # the card's tests run where JAX is not installed
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "eigenexa_tpu"), (path, name)
