"""Build and load the port's hand-written CUDA kernels.

The sources under ``eigenexa_tpu_torch/csrc/`` are compiled with ``nvcc``
into one shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds; one ``nvcc`` per source,
all started together, then one link).  The library lands in
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the sources and flags, at the first call of :func:`load_library` — never at
import time.  A missing ``nvcc`` or a failed build raises with nvcc's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "kernels"
_SOURCES = ("sub_matmul.cu", "symv_lower.cu", "sturm.cu")
_LIB_NAME = "libeigenexa_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LD = ctypes.c_longlong
# every entry point returns cudaError_t as an int
_ARGTYPES = {
    # (m, n, k, b, ldb, p, ldp, q, ldq, out, ldo, stream)
    "eigenexa_sub_matmul": [_I, _I, _I, _P, _LD, _P, _LD, _P, _LD, _P, _LD,
                            _P],
    # (m, w, k, b, ldb, p, ldp, q, ldq, stream)
    "eigenexa_sub_matmul_window": [_I, _I, _I, _P, _LD, _P, _LD, _P, _LD,
                                   _P],
    # (m, w, nc, b, ldb, x, ldx, q, ldq, scratch, scratch_len, panel, ldp,
    #  half, nb, stream)
    "eigenexa_symv_lower": [_I, _I, _I, _P, _LD, _P, _LD, _P, _LD, _P, _LD,
                            _P, _LD, _I, _I, _P],
    # (n, band, s0, s1, s2, head, a0, b0, w0, n_iter, w, stream)
    "eigenexa_sturm_bisect": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P],
}
# the dtypes each entry point is built for (the suffix of its name): f32 and
# f64, but the Sturm recurrence, which is f64 only, and the whole-matrix
# subtract-product, which also takes c64 and c128 (the Hermitian path)
_SUFFIXES = {"eigenexa_sturm_bisect": ("_f64",),
             "eigenexa_sub_matmul": ("_f32", "_f64", "_c64", "_c128")}


def entry_points():
    """(C name, argument types) of every entry point of the library."""
    return [(name + suffix, argtypes)
            for name, argtypes in _ARGTYPES.items()
            for suffix in _SUFFIXES.get(name, ("_f32", "_f64"))]

_lib = None
build_seconds = None  # wall seconds of this process's nvcc run, if any


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME is "
                           "unset and nvcc is not on PATH)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    global build_seconds
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in _SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(_CSRC / src)]
                for src, obj in zip(_SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        lib = str(Path(tmp) / _LIB_NAME)
        cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])
        results = [(p.communicate(), p.returncode) for p in procs]
        if not any(rc for _, rc in results):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            results.append(((link.stdout, link.stderr), link.returncode))
        for cmd, ((out, err), rc) in zip(cmds, results):
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}): "
                                   f"{' '.join(cmd)}\n{err}{out}")
        os.replace(lib, target)  # atomic: a concurrent loader sees all or none
    build_seconds = time.perf_counter() - t0


def resource_usage(sources=_SOURCES) -> str:
    """What ptxas reports for every kernel of the sources (all by default):
    registers a thread, spill bytes, shared memory a block.  One ``nvcc
    --resource-usage`` per source, all started together; the objects are
    thrown away."""
    nvcc = _nvcc()
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_ROOT) as tmp:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "--resource-usage", "-c", "-o",
             str(Path(tmp) / (Path(src).stem + ".o")), str(_CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources]
        return "".join(f"resource usage of {src}:\n{proc.communicate()[0]}"
                       for src, proc in zip(sources, procs))


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources on first use."""
    global _lib
    if _lib is None:
        target = _BUILD_ROOT / _source_hash() / _LIB_NAME
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in entry_points():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
