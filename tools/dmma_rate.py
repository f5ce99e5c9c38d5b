"""The rate and the rounding of Hopper's f64 tensor-core shapes.

``csrc/sub_matmul.cu`` holds its f64 and c128 kernels to one fma chain over
k in ascending order an output.  PTX offers four f64 ``mma.sync`` shapes on
sm_90: m8n8k4 (the f64 kernel's), m16n8k4 (the c128 ring kernel's, two
m8n8k4 on one B), m16n8k8 and m16n8k16.
This script builds a small CUDA source with all four, runs it on the card
and prints, for each shape:

* ``tflops``: a register-only loop of independent products (no memory
  traffic), 264 blocks of 8 warps, 2 x M x N x K operations an instruction
  a warp, timed by CUDA events;
* ``equal``/``cases``: how many of 16 x 8 outputs, over 4096 random
  problems C + A·B of depth 16 (entries of random sign and exponent, so
  that the order of rounding shows), equal bit for bit the chain
  ``acc = fma(A[i, k], B[k, j], acc)`` over k = 0 ... 15 from C (CUDA's
  ``fma`` on the card, one rounding a step); a shape of depth K is issued
  16 / K times in ascending k.

    python3 tools/dmma_rate.py

One ``dmma {json}`` line a shape, then the card's name and power limit.
Needs ``nvcc`` and one card.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SOURCE = r"""
#include <cuda_runtime.h>

// A (16 x 16) and C, D (16 x 8) row-major, B (16 x 8) as B[k][n]; lane =
// g * 4 + t.  Fragments as the PTX ISA lays them out for .f64.
__device__ __forceinline__ void mma884(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}
__device__ __forceinline__ void mma1684(double (&d)[4], const double (&a)[2],
                                        double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b));
}
__device__ __forceinline__ void mma1688(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                 "d"(b[1]));
}
__device__ __forceinline__ void mma16816(double (&d)[4], const double (&a)[8],
                                         const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
               "{%12,%13,%14,%15}, {%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                 "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                 "d"(b[2]), "d"(b[3]));
}

// one warp a problem; shape 0..3 = m8n8k4, m16n8k4, m16n8k8, m16n8k16
__global__ void bits_kernel(int shape, const double* A, const double* B,
                            const double* C, double* D) {
  const int w = blockIdx.x, lane = threadIdx.x, g = lane / 4, t = lane % 4;
  A += w * 256;
  B += w * 128;
  C += w * 128;
  D += w * 128;
  double d[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                 C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  if (shape == 0) {
    for (int h = 0; h < 2; ++h) {
      double dh[2] = {d[2 * h], d[2 * h + 1]};
      for (int s = 0; s < 4; ++s)
        mma884(dh, A[(8 * h + g) * 16 + 4 * s + t], B[(4 * s + t) * 8 + g]);
      d[2 * h] = dh[0];
      d[2 * h + 1] = dh[1];
    }
  } else if (shape == 1) {
    for (int s = 0; s < 4; ++s) {
      const double a[2] = {A[g * 16 + 4 * s + t], A[(g + 8) * 16 + 4 * s + t]};
      mma1684(d, a, B[(4 * s + t) * 8 + g]);
    }
  } else if (shape == 2) {
    for (int s = 0; s < 2; ++s) {
      double a[4], b[2];
      for (int i = 0; i < 4; ++i)
        a[i] = A[(g + 8 * (i % 2)) * 16 + 8 * s + t + 4 * (i / 2)];
      for (int i = 0; i < 2; ++i) b[i] = B[(8 * s + t + 4 * i) * 8 + g];
      mma1688(d, a, b);
    }
  } else {
    double a[8], b[4];
    for (int i = 0; i < 8; ++i)
      a[i] = A[(g + 8 * (i % 2)) * 16 + t + 4 * (i / 2)];
    for (int i = 0; i < 4; ++i) b[i] = B[(t + 4 * i) * 8 + g];
    mma16816(d, a, b);
  }
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// kAcc independent 16 x 8 (or two 8 x 8) accumulators a warp, `iters`
// rounds; the sum of all goes to out so that nothing is dead
template <int kShape>
__global__ void __launch_bounds__(256, 2) rate_kernel(int iters, double* out) {
  constexpr int kAcc = 8;
  double d[kAcc][4] = {};
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      if constexpr (kShape == 0) {
        double lo[2] = {d[j][0], d[j][1]}, hi[2] = {d[j][2], d[j][3]};
        mma884(lo, a[0], b[0]);
        mma884(hi, a[1], b[0]);
        d[j][0] = lo[0]; d[j][1] = lo[1]; d[j][2] = hi[0]; d[j][3] = hi[1];
      } else if constexpr (kShape == 1) {
        mma1684(d[j], reinterpret_cast<const double(&)[2]>(a), b[0]);
      } else if constexpr (kShape == 2) {
        mma1688(d[j], reinterpret_cast<const double(&)[4]>(a),
                reinterpret_cast<const double(&)[2]>(b));
      } else {
        mma16816(d[j], a, b);
      }
    }
  }
  double s = 0.0;
  for (int j = 0; j < kAcc; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the reference: one fma chain an output over k ascending from C
__global__ void chain_kernel(const double* A, const double* B,
                             const double* C, double* D) {
  const int w = blockIdx.x, e = threadIdx.x, i = e / 8, j = e % 8;
  double acc = C[w * 128 + e];
  for (int k = 0; k < 16; ++k)
    acc = fma(A[w * 256 + i * 16 + k], B[w * 128 + k * 8 + j], acc);
  D[w * 128 + e] = acc;
}

extern "C" int probe_chain(int problems, const double* A, const double* B,
                           const double* C, double* D) {
  chain_kernel<<<problems, 128>>>(A, B, C, D);
  return cudaGetLastError();
}

extern "C" int probe_bits(int shape, int problems, const double* A,
                          const double* B, const double* C, double* D) {
  bits_kernel<<<problems, 32>>>(shape, A, B, C, D);
  return cudaGetLastError();
}

extern "C" int probe_rate(int shape, int blocks, int iters, double* out) {
  switch (shape) {
    case 0: rate_kernel<0><<<blocks, 256>>>(iters, out); break;
    case 1: rate_kernel<1><<<blocks, 256>>>(iters, out); break;
    case 2: rate_kernel<2><<<blocks, 256>>>(iters, out); break;
    default: rate_kernel<3><<<blocks, 256>>>(iters, out); break;
  }
  return cudaGetLastError();
}
"""

SHAPES = ("m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16")
# operations of one instruction a warp in the rate loop (m8n8k4: two, to
# cover the same 16 x 8 outputs as the others)
OPS = (2 * 2 * 8 * 8 * 4, 2 * 16 * 8 * 4, 2 * 16 * 8 * 8, 2 * 16 * 8 * 16)


def _build(tmp: Path) -> ctypes.CDLL:
    from eigenexa_tpu_torch.ops import _build as build

    src = tmp / "dmma_rate.cu"
    src.write_text(SOURCE)
    lib = tmp / "libdmma_rate.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(src)], check=True)
    out = ctypes.CDLL(str(lib))
    out.probe_bits.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 4
    out.probe_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out.probe_chain.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dmma_rate: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(10)
    problems = 4096

    def entries(*shape):
        return (rng.standard_normal(shape)
                * np.exp2(rng.integers(-20, 21, shape)))

    a, b, c = entries(problems, 16, 16), entries(problems, 16, 8), entries(
        problems, 16, 8)
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build(Path(tmp))
        ta, tb, tc = (torch.from_numpy(x).to(dev) for x in (a, b, c))
        ref = torch.empty_like(tc)
        assert lib.probe_chain(problems, ta.data_ptr(), tb.data_ptr(),
                               tc.data_ptr(), ref.data_ptr()) == 0
        want = ref.cpu().numpy()
        for shape, name in enumerate(SHAPES):
            d = torch.empty_like(tc)
            assert lib.probe_bits(shape, problems, ta.data_ptr(),
                                  tb.data_ptr(), tc.data_ptr(),
                                  d.data_ptr()) == 0
            got = d.cpu().numpy()
            equal = int((got.view(np.int64) == want.view(np.int64)).sum())
            blocks, iters = 264, 4096
            out = torch.empty(blocks * 256, dtype=torch.float64, device=dev)
            lib.probe_rate(shape, blocks, 16, out.data_ptr())
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            assert lib.probe_rate(shape, blocks, iters, out.data_ptr()) == 0
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            ops = blocks * 8 * iters * 8 * OPS[shape]
            print("dmma " + json.dumps({
                "shape": name, "tflops": ops / ms / 1e9, "ms": ms,
                "equal": equal, "cases": int(want.size),
                "max_abs_diff": float(np.abs(got - want).max())}),
                flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
