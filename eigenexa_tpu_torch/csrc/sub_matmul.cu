// OUT = B - P * Q^T with the subtract fused into the product: one pass over B.
//
// Replaces the Pallas TPU kernel `_sub_matmul_pallas` (body
// `_sub_matmul_kernel`) of eigenexa_tpu/ops/pallas_kernels.py.  Two callers
// on the eigen_s path go through it:
//   * the rank-2k trailing update of every Householder panel,
//     B = A[k+nb:, k+nb:], P = [U W], Q = [W U], k = 2*nb (= 128), updated
//     IN PLACE on the strided view of the working matrix (OUT == B);
//   * the large GEMM of every WY back-transform block,
//     B = Z[k:, :], P = V, Q = (T * V^T Z)^T, k = nb_b (= 128), also in place.
//
// The window entry points at the end replace a second Pallas kernel,
// `_sub_matmul_window_pallas` (public `rank2k_update_window`) of the same
// file: the trailing update of the windowed reduction,
// B[w:, w:] -= P[w:] * Q[w:]^T in place on one fixed working buffer.  On the
// TPU that needed a kernel of its own (a grid over the window's tiles and an
// output aliased onto B); here a window is a pointer offset plus the leading
// dimension, so the same device code serves it and nothing outside the
// window is addressed.  Its bound is the one below.
//
// What bounds it on an H100: at k = 128 in f32 the kernel does 2*k / 8 = 32
// flop per byte of B traffic (B read once, OUT written once), above the
// ~20 flop/B where 67 TFLOP/s of non-tensor FP32 meets 3.35 TB/s of HBM.  So
// FMA throughput bounds it: TF32 tensor cores are ruled out by the solver's
// precision contract (full-f32 accumulation, the analogue of the TPU path's
// Precision.HIGHEST), so the product runs on the FP32 pipes.
//
// Design, deliberately simple for a first port:
//   * one block owns one 64 x 64 output tile; 256 threads, each a 4 x 4
//     micro-tile strided by 16 so that neighbouring threads touch
//     neighbouring columns of B and OUT (coalesced epilogue);
//   * K-slices of 16 of P and Q are staged in shared memory, transposed and
//     padded by one element against bank conflicts; ragged m, n and k edges
//     are masked here (no K padding, no divisibility gates as on the TPU);
//   * the accumulator has the element type (f32 FMA for float, f64 for
//     double) and runs over k in a fixed order, with no atomics and no
//     cross-block reduction, so two identical solves are bitwise equal;
//   * B, P, Q and OUT are row-major with leading dimensions, so a strided
//     view is taken as it is.  The thread that reads B[i, j] is the one that
//     writes OUT[i, j], which makes OUT == B safe.
//
// Later work, not here: 3xTF32 splitting on the tensor cores for f32, DMMA
// for f64, double-buffered (cp.async / TMA) staging, and a lower-triangle-only
// syr2k for the symmetric trailing update (householder.py updates the full
// square only because dense MXU tiles suited the TPU).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;              // output tile edge
constexpr int kSlice = 16;             // K-slice staged in shared memory
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kSide = 16;              // threads along each tile edge
constexpr int kMicro = kTile / kSide;  // 4 x 4 outputs per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
sub_matmul_kernel(int m, int n, int k,
                  const T* b, long long ldb,
                  const T* __restrict__ p, long long ldp,
                  const T* __restrict__ q, long long ldq,
                  T* out, long long ldo) {
  // ps[l][r] = P[row0 + r, k0 + l];  qs[l][c] = Q[col0 + c, k0 + l]
  __shared__ T ps[kSlice][kTile + 1];
  __shared__ T qs[kSlice][kTile + 1];

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  T acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += kSlice) {
    for (int e = threadIdx.x; e < kTile * kSlice; e += kThreads) {
      const int r = e / kSlice;
      const int l = e % kSlice;
      const int gk = k0 + l;
      const int gp = row0 + r;
      const int gq = col0 + r;
      ps[l][r] = (gp < m && gk < k) ? p[gp * ldp + gk] : T(0);
      qs[l][r] = (gq < n && gk < k) ? q[gq * ldq + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < kSlice; ++l) {
      T a[kMicro], c[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = ps[l][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) c[j] = qs[l][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fma(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gr = row0 + ty + kSide * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gc = col0 + tx + kSide * j;
      if (gc < n) out[gr * ldo + gc] = b[gr * ldb + gc] - acc[i][j];
    }
  }
}

template <typename T>
int launch(int m, int n, int k, const T* b, long long ldb, const T* p,
           long long ldp, const T* q, long long ldq, T* out, long long ldo,
           void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  sub_matmul_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      m, n, k, b, ldb, p, ldp, q, ldq, out, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  They launch on `stream`, which must
// belong to the current device (the caller makes the operands' device
// current), do not synchronize, allocate nothing, and return
// cudaGetLastError() of the launch.
extern "C" int eigenexa_sub_matmul_f32(int m, int n, int k, const float* b,
                                       long long ldb, const float* p,
                                       long long ldp, const float* q,
                                       long long ldq, float* out,
                                       long long ldo, void* stream) {
  return launch<float>(m, n, k, b, ldb, p, ldp, q, ldq, out, ldo, stream);
}

extern "C" int eigenexa_sub_matmul_f64(int m, int n, int k, const double* b,
                                       long long ldb, const double* p,
                                       long long ldp, const double* q,
                                       long long ldq, double* out,
                                       long long ldo, void* stream) {
  return launch<double>(m, n, k, b, ldb, p, ldp, q, ldq, out, ldo, stream);
}

// Window entry points: B is (m, m), P and Q are (m, k), and only rows and
// columns >= w take part: B[w:, w:] -= P[w:] * Q[w:]^T, in place.
extern "C" int eigenexa_sub_matmul_window_f32(int m, int w, int k, float* b,
                                              long long ldb, const float* p,
                                              long long ldp, const float* q,
                                              long long ldq, void* stream) {
  float* win = b + w * ldb + w;
  return launch<float>(m - w, m - w, k, win, ldb, p + w * ldp, ldp,
                       q + w * ldq, ldq, win, ldb, stream);
}

extern "C" int eigenexa_sub_matmul_window_f64(int m, int w, int k, double* b,
                                              long long ldb, const double* p,
                                              long long ldp, const double* q,
                                              long long ldq, void* stream) {
  double* win = b + w * ldb + w;
  return launch<double>(m - w, m - w, k, win, ldb, p + w * ldp, ldp,
                        q + w * ldq, ldq, win, ldb, stream);
}
