// Q = B * X for symmetric B, reading only the lower triangle of the window
// B[w:, w:]; rows of Q above the window come back zero.
//
// Replaces the Pallas TPU kernel `_symv_pallas` (public `symv_lower`, grid
// decode `_symv_decode`) of eigenexa_tpu/ops/pallas_kernels.py: the panel
// matvec of the windowed Householder reduction, called once per column
// (reference: the distributed symv of src/eigen_trd_t2.F:161; nc = 2 is the
// two-vector PDSYMV2 pass of src/eigen_prd_t2.F:90).
//
// What bounds it on an H100: bytes.  Every element of the window's lower
// triangle is read once and used for two multiply-adds per vector, far
// below the ~20 flop/B where 67 TFLOP/s of FP32 meets 3.35 TB/s of HBM.  The
// least time is (m - w)^2 / 2 elements over the memory rate: 537 MB, 0.16 ms
// for the first column of n = 16384 in f32, against 1.07 GB for a matvec
// over the full square.
//
// The TPU kernel ran its grid in order on one core and carried q from step
// to step; here blocks run in no order and the q_i / q_j contributions of a
// tile land in two different row blocks.  Atomics would make the sum's order
// change from run to run, which the solver's bitwise-repeat contract
// forbids.  So the product is two passes:
//   * pass 1, one block per lower tile (i, j <= i) of 64 x 64: the tile is
//     loaded once with 16-byte loads along rows (scalar, masked loads where
//     the view is not 16-byte aligned or the edge is ragged) and kept in
//     registers, 4 x 4 elements a thread.  From those registers the block
//     forms A_ij * x_j (a shuffle sum over the 16 threads that share a row)
//     and, for the same elements, A_ij^T * x_i (a sum over the thread's
//     rows, then over row groups through shared memory), for all vectors.
//     A diagonal tile keeps its lower half only and mirrors it.  Each
//     partial goes to its own slot scratch[source tile][vector][row]: the
//     slot of row block I from source s is written by tile (I, s) for s < I,
//     by tile (s, I) for s > I and by the diagonal tile for s = I, so every
//     slot is written exactly once and none is added to across blocks;
//   * pass 2 sums the slots of each row over the source tiles in a fixed
//     order, writes q, and writes zeros above the window.
// The scratch adds 2 * (m - w)^2 / 64 elements of traffic (one write, one
// read): 6% of the triangle.  Tiles are this kernel's own choice; the
// window start w is the caller's.
//
// Later work, not here: wider tiles or a persistent block per tile row to
// shrink the scratch, cp.async / TMA staging, and fusing the panel's
// corrections (q - U(W^T v) - W(U^T v)) into pass 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                        // tile edge
constexpr int kThreads = 256;
constexpr int kColGroups = 16;                   // threads along a tile row
constexpr int kPerThread = kTile / kColGroups;   // 4 columns and 4 rows each
constexpr int kRowGroups = kThreads / kColGroups;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kSumRows = 32;     // pass 2: rows per block
constexpr int kSumGroups = 8;    // pass 2: interleaved groups of source tiles

__device__ inline void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ inline void load4(const double* p, double (&v)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(p);
  const double2 hi = *reinterpret_cast<const double2*>(p + 2);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// a, x: at the window's origin (row and column w of B, row w of X).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
symv_partial_kernel(int mw, int nc, bool aligned,
                    const T* __restrict__ a, long long lda,
                    const T* __restrict__ x, long long ldx,
                    T* __restrict__ scratch) {
  __shared__ T xs[2][NC][kTile];           // [0]: x_j (columns), [1]: x_i (rows)
  __shared__ T rowres[NC][kTile];          // A_ij * x_j
  __shared__ T colred[kWarps][NC][kTile];  // A_ij^T * x_i, per warp

  // linear block index -> lower tile (ti, tj <= ti)
  const int t = blockIdx.x;
  int ti = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int row0 = ti * kTile;
  const int col0 = tj * kTile;
  const bool diag = ti == tj;

  const int cg = threadIdx.x % kColGroups;   // columns 4*cg .. 4*cg+3
  const int rg = threadIdx.x / kColGroups;   // rows rg + 16*k
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  for (int e = threadIdx.x; e < 2 * NC * kTile; e += kThreads) {
    const int which = e / (NC * kTile);
    const int c = (e / kTile) % NC;
    const int r = e % kTile;
    const int g = (which == 0 ? col0 : row0) + r;
    xs[which][c][r] = (c < nc && g < mw) ? x[g * ldx + c] : T(0);
  }

  T av[kPerThread][kPerThread];
  const int gc = col0 + kPerThread * cg;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int r = rg + kRowGroups * k;
    const int gr = row0 + r;
    const T* src = a + gr * lda + gc;
    if (gr < mw && aligned && gc + kPerThread <= mw) {
      load4(src, av[k]);
    } else {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e)
        av[k][e] = (gr < mw && gc + e < mw) ? src[e] : T(0);
    }
    if (diag) {
      // the upper half is never used: whatever it holds, it becomes zero
#pragma unroll
      for (int e = 0; e < kPerThread; ++e)
        if (kPerThread * cg + e > r) av[k][e] = T(0);
    }
  }
  __syncthreads();

  // A_ij * x_j: each row is shared by the 16 threads of a half warp
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T s = T(0);
#pragma unroll
      for (int e = 0; e < kPerThread; ++e)
        s = fma(av[k][e], xs[0][c][kPerThread * cg + e], s);
#pragma unroll
      for (int off = kColGroups / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(kFullMask, s, off);
      if (cg == 0) rowres[c][rg + kRowGroups * k] = s;
    }
  }

  // A_ij^T * x_i: each column is shared by the 16 row groups, two per warp.
  // On a diagonal tile the diagonal itself already counted above.
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int r = rg + kRowGroups * k;
        const T aa = (diag && kPerThread * cg + e == r) ? T(0) : av[k][e];
        s = fma(aa, xs[1][c][r], s);
      }
      s += __shfl_xor_sync(kFullMask, s, 16);
      if (lane < 16) colred[warp][c][kPerThread * cg + e] = s;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < NC * kTile; e += kThreads) {
    const int c = e / kTile;
    const int r = e % kTile;
    if (c >= nc) continue;
    T cs = T(0);
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) cs += colred[wp][c][r];
    const long long slot_i = (static_cast<long long>(ti) * nc + c) * mw;
    const long long slot_j = (static_cast<long long>(tj) * nc + c) * mw;
    if (diag) {
      if (row0 + r < mw) scratch[slot_i + row0 + r] = rowres[c][r] + cs;
    } else {
      if (row0 + r < mw) scratch[slot_j + row0 + r] = rowres[c][r];
      if (col0 + r < mw) scratch[slot_i + col0 + r] = cs;
    }
  }
}

// q[row, c] = sum over source tiles, in a fixed order; 0 above the window.
template <typename T>
__global__ void __launch_bounds__(kSumRows * kSumGroups)
symv_sum_kernel(int m, int w, int nc, int nt, const T* __restrict__ scratch,
                T* __restrict__ q, long long ldq) {
  __shared__ T red[kSumGroups][kSumRows];
  const int tx = threadIdx.x % kSumRows;
  const int ty = threadIdx.x / kSumRows;
  const int row = blockIdx.x * kSumRows + tx;
  const int c = blockIdx.y;
  const long long mw = m - w;
  T s = T(0);
  if (row >= w && row < m) {
    const T* src = scratch + c * mw + (row - w);
    for (int t = ty; t < nt; t += kSumGroups) s += src[t * nc * mw];
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && row < m) {
    T total = T(0);
#pragma unroll
    for (int g = 0; g < kSumGroups; ++g) total += red[g][tx];
    q[row * ldq + c] = total;
  }
}

template <typename T, int NC>
void launch_partial(int blocks, int mw, int nc, bool aligned, const T* a,
                    long long lda, const T* x, long long ldx, T* scratch,
                    cudaStream_t stream) {
  symv_partial_kernel<T, NC><<<blocks, kThreads, 0, stream>>>(
      mw, nc, aligned, a, lda, x, ldx, scratch);
}

template <typename T>
int launch(int m, int w, int nc, const T* b, long long ldb, const T* x,
           long long ldx, T* q, long long ldq, T* scratch, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int mw = m - w;
  const int nt = (mw + kTile - 1) / kTile;
  const int blocks = nt * (nt + 1) / 2;
  const T* a = b + w * ldb + w;
  const T* xw = x + w * ldx;
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      ldb % kVec == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (nc == 1) {
    launch_partial<T, 1>(blocks, mw, nc, aligned, a, ldb, xw, ldx, scratch,
                         stream);
  } else if (nc == 2) {
    launch_partial<T, 2>(blocks, mw, nc, aligned, a, ldb, xw, ldx, scratch,
                         stream);
  } else if (nc <= 4) {
    launch_partial<T, 4>(blocks, mw, nc, aligned, a, ldb, xw, ldx, scratch,
                         stream);
  } else if (nc <= 8) {
    launch_partial<T, 8>(blocks, mw, nc, aligned, a, ldb, xw, ldx, scratch,
                         stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kSumRows - 1) / kSumRows, nc);
  symv_sum_kernel<T><<<grid, kSumRows * kSumGroups, 0, stream>>>(
      m, w, nc, nt, scratch, q, ldq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  B is (m, m) with leading dimension ldb;
// X is (m, nc) with row stride ldx and unit column stride; Q is (m, nc) with
// row stride ldq; scratch holds ceil((m - w) / 64) * nc * (m - w) elements.
// They launch both passes on `stream`, which must belong to the current
// device, do not synchronize, allocate nothing, and return the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int eigenexa_symv_lower_f32(int m, int w, int nc, const float* b,
                                       long long ldb, const float* x,
                                       long long ldx, float* q, long long ldq,
                                       float* scratch, void* stream) {
  return launch<float>(m, w, nc, b, ldb, x, ldx, q, ldq, scratch, stream);
}

extern "C" int eigenexa_symv_lower_f64(int m, int w, int nc, const double* b,
                                       long long ldb, const double* x,
                                       long long ldx, double* q,
                                       long long ldq, double* scratch,
                                       void* stream) {
  return launch<double>(m, w, nc, b, ldb, x, ldx, q, ldq, scratch, stream);
}
