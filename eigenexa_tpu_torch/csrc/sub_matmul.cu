// OUT = B - P * Q^T with the subtract fused into the product: one pass over B.
//
// Replaces two Pallas TPU kernels of eigenexa_tpu/ops/pallas_kernels.py:
//   * `_sub_matmul_pallas` (body `_sub_matmul_kernel`, public `sub_matmul`),
//     through the entry points eigenexa_sub_matmul_*.  Two callers on the
//     eigen_s path: the rank-2k trailing update of every Householder panel of
//     the rolled reduction (B = A[k+nb:, k+nb:], P = [U W], Q = [W U],
//     k = 2*nb = 128, IN PLACE on the strided view of the working matrix,
//     OUT == B), and the large product of every WY back-transform block
//     (B = Z[k:, :], P = V, Q = (T * V^T Z)^T, k = 128, also in place);
//   * `_sub_matmul_window_pallas` (public `rank2k_update_window`), through
//     the entry points eigenexa_sub_matmul_window_*: the trailing update of
//     the windowed reduction, B[w:, w:] -= P[w:] * Q[w:]^T in place on one
//     fixed working buffer.  On the TPU that was a kernel of its own (a grid
//     over the window's tiles, the output aliased onto B); here a window is a
//     pointer offset plus the leading dimension, so the same device code
//     serves it and nothing outside the window is addressed.
//
// The contract of both: a full-precision product with a sum in the element
// type, each output one chain of fma over k in ascending order starting from
// 0, then b - acc.  The one tensor-core instruction in this file is DMMA
// (`mma.sync.aligned.m8n8k4...f64`), full IEEE f64 with round to nearest,
// fed k in ascending order; nothing runs at a reduced precision (no TF32, no
// bf16), there is no split of k, no reduction across threads, no atomics:
// two identical solves are bitwise equal, and every kernel in this file gives
// the same bits for the same operands (f64: DMMA's bits, which on an H100
// equal those of the fma chain and of cuBLAS's DGEMM on every case that
// chip_smoke.py checks).  B, P, Q and OUT are row-major with leading
// dimensions, so a strided view is taken as it is, and any m, n, k >= 0 is
// masked here.  The thread that reads B[i, j] is the one that writes
// OUT[i, j], after its own read, which makes OUT == B safe.
//
// What bounds it on an H100.  f32 at k = 128: 2*k / 8 = 32 flop per byte of B
// traffic (B read once, OUT written once), above the ~20 flop/B where the
// card's 67 TFLOP/s of FP32 outside the tensor cores meets 3.35 TB/s of
// device memory.  So operations bound it, with bytes close behind (0.64 of
// the operations' time): the read of B and the write of OUT have to run under
// other blocks' FMAs, or the two add up.  f64 at k = 128: 2*k / 16 = 16 flop
// per byte, under the ridge of the FP64 tensor cores' 67 TFLOP/s, so bytes
// bound it (1.29 ms at 16384^2) with the operations at 0.8 of that; the FP64
// pipes outside the tensor cores (33.5 TFLOP/s) would take 2.05 ms for the
// operations alone, so only DMMA lets them run under the bytes.
//
// Three kernels, one rule (`launch`):
//   * `sub_matmul_kernel`: f32, a 64 x 64 tile a block, 256 threads, a 4 x 4
//     micro-tile each, K-slices of 16 staged in shared memory, for the f32
//     launches too small to give each SM one of the larger tiles (the
//     trailing blocks at the end of a reduction), where smaller tiles fill
//     the card better;
//   * `sub_matmul_kernel_f32_128`: a 128 x 128 tile a block, for f32 launches
//     with ceil(m/128) * ceil(n/128) >= the number of SMs, m >= 1409 for a
//     square on 132 SMs.  The SM count is read once and cached.  Measured
//     with both kernels forced in turns (tools/kernel_variants.py --sweep,
//     NVIDIA H100 80GB HBM3, 700.00 W): the 128-tile kernel is at least as
//     fast from m = 1280 on and 1.5-1.9 times as fast from m = 1792 on; at
//     m <= 1024 the two are within the host's launch interval of each other;
//   * `sub_matmul_kernel_f64_dmma`: every f64 launch, at any size.  A 128 x 64
//     tile a block, 256 threads as 8 warps in 4 x 2, each warp 32 x 32
//     outputs as 4 x 4 DMMA fragments of 8 x 8 (32 accumulators a thread);
//     K-slices of 8 (two k steps of 4) double-buffered through registers as
//     in the f32 128-tile kernel; two blocks an SM.  A slice of an operand
//     row sits in shared memory as four 16-byte pairs (k0 + t, k0 + 4 + t),
//     t = 0..3, the two k steps of fragment column t: a warp's fragment loads
//     and its staging stores each cover 512 contiguous bytes, and one 16-byte
//     load gives a lane its A (or B) values for both k steps.  Rows >= m (or
//     n) and columns >= k are zero, which leaves an accumulator as it was.
//     The epilogue reads and writes B and OUT 16 bytes a thread where both
//     bases are 16-byte aligned and both leading dimensions even, else as
//     masked scalars.
//
// What held the 64-tile kernel at 31% of the f32 bound, and what the
// 128-tile kernel does about each:
//   1. Shared-memory traffic set the pace: a 4 x 4 micro-tile reads 8 scalars
//      from shared memory for 16 FMAs, one 4-byte load for two FMAs.  Now a
//      thread keeps an 8 x 8 micro-tile in 64 registers, as 2 x 2 quads of
//      4 x 4 (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise in
//      tx), and reads four 16-byte vectors for 64 FMAs in a k step: one
//      shared-memory instruction for 16 FMAs.  In a warp the P reads are
//      broadcasts (two values of ty) and the Q reads are 16 neighbouring
//      vectors: no bank conflict.
//   2. Nothing overlapped: load a slice, barrier, compute, barrier.  Now
//      K-slices of 16 are double-buffered through registers: a thread loads
//      its two 16-byte quads of P and of Q of slice s+1 from device memory,
//      computes slice s from buffer s&1 (1024 FMAs, which hide the load's
//      latency), stores the registers into buffer (s+1)&1, and one barrier
//      ends the step.  Two blocks are resident on an SM
//      (__launch_bounds__(256, 2)), so one block's epilogue runs under the
//      other's FMA loop.  Slices of 8 (half the shared memory, twice the
//      barriers) were 0-5% slower on the main shapes.
//   3. The transposing store conflicted two ways, on every element.  Now a
//      row of the k-major buffers is 132 floats, 16-byte aligned for the
//      vector reads, and a thread stores four scalars for each 16-byte load:
//      with four k-quads to a row the stores of a warp still meet two ways
//      (quads 0 and 2 share banks), but they are a fifth of the shared-memory
//      instructions; with slices of 8 they were conflict-free.
//   4. The epilogue was scalar.  Now it reads B and writes OUT 16 bytes a
//      thread, 16 neighbouring threads on 256 neighbouring bytes, four
//      vectors in flight before the first store.
// The 16-byte paths are taken quad by quad where the addresses allow (base
// 16-byte aligned, leading dimension a multiple of 4, the quad inside k or
// n); every other quad is loaded or stored as masked scalars, zero beyond k.
//
// What holds the DMMA kernel at 38% of its byte bound (3.39-3.66 ms at
// 16384^2 x 128 against 1.29 ms; tools/kernel_variants.py --sweep64 on
// copies with a part taken out, NVIDIA H100 80GB HBM3, 700.00 W): the
// epilogue alone takes 1.51 ms, the K loop with an FMA in place of each DMMA
// 1.54 ms more, the DMMAs 0.41 ms more, and a second set of DMMAs would add
// 1.57 ms.  The parts add up instead of overlapping: each slice waits on
// its P and Q loads from L2, and the two blocks of an SM start together and
// reach their epilogues together.  128 x 128 tiles (192 registers, one
// block an SM), 64 x 64 tiles with three or four blocks an SM, a k-major
// padded layout of the slices and an L2 prefetch of B's tile at the block's
// start were each as slow or slower.
//
// As built (nvcc -O3 for sm_90a; `python3 chip_smoke.py --kernels` prints
// ptxas's figures): the 128-tile kernel takes 126 registers a thread, 0 bytes
// of spill and 33,792 bytes of static shared memory a block; the 64-tile
// kernel 40 registers and 8,320 bytes; the DMMA kernel 128 registers and
// 24,576 bytes; none spills.
//
// Later work, not here: asynchronous staging (cp.async or TMA) of P and Q in
// a ring of three or more slices, and of B's tile into shared memory at the
// block's start, so that the loads and the epilogue's read run under the
// DMMAs; the lower tiles only for the symmetric trailing update (the callers
// update the full square only because dense tiles suited the TPU).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;              // output tile edge
constexpr int kSlice = 16;             // K-slice staged in shared memory
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kSide = 16;              // threads along each tile edge
constexpr int kMicro = kTile / kSide;  // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kThreads)
sub_matmul_kernel(int m, int n, int k,
                  const float* b, long long ldb,
                  const float* __restrict__ p, long long ldp,
                  const float* __restrict__ q, long long ldq,
                  float* out, long long ldo) {
  // ps[l][r] = P[row0 + r, k0 + l];  qs[l][c] = Q[col0 + c, k0 + l]
  __shared__ float ps[kSlice][kTile + 1];
  __shared__ float qs[kSlice][kTile + 1];

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kSlice) {
    for (int e = threadIdx.x; e < kTile * kSlice; e += kThreads) {
      const int r = e / kSlice;
      const int l = e % kSlice;
      const int gk = k0 + l;
      const int gp = row0 + r;
      const int gq = col0 + r;
      ps[l][r] = (gp < m && gk < k) ? p[gp * ldp + gk] : 0.f;
      qs[l][r] = (gq < n && gk < k) ? q[gq * ldq + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < kSlice; ++l) {
      float a[kMicro], c[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = ps[l][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) c[j] = qs[l][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
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

// ---------------------------------------------------------------------------
// f32, 128 x 128 tile a block
// ---------------------------------------------------------------------------

constexpr int kBigTile = 128;           // output tile edge
constexpr int kBigSlice = 16;           // K-slice staged in shared memory
constexpr int kBigRow = kBigTile + 4;   // padded row of a k-major buffer
constexpr int kQuad = 4;                // floats of one 16-byte vector
constexpr int kHalf = kBigTile / 2;     // offset of a thread's second quad
// staging: a slice of an operand tile is kBigTile rows of kRowQuads quads,
// kStage of them a thread
constexpr int kRowQuads = kBigSlice / kQuad;
constexpr int kStage = kBigTile * kRowQuads / kThreads;
constexpr int kPassRows = kThreads / kRowQuads;  // rows one pass covers
static_assert(kStage * kThreads == kBigTile * kRowQuads, "whole passes");

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Four values of row `row` of an operand starting at column k0 (a multiple of
// 4); zero for a row >= rows and for columns >= k.
__device__ __forceinline__ float4 load_k_quad(const float* __restrict__ base,
                                              long long ld, int row, int rows,
                                              int k0, int k, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows && k0 < k) {
    const float* src = base + static_cast<long long>(row) * ld + k0;
    if (vec && k0 + kQuad <= k) {
      v = *reinterpret_cast<const float4*>(src);
    } else {
      v.x = src[0];
      if (k0 + 1 < k) v.y = src[1];
      if (k0 + 2 < k) v.z = src[2];
      if (k0 + 3 < k) v.w = src[3];
    }
  }
  return v;
}

// The transposing store: buf[l0 + i][r] = v[i].
__device__ __forceinline__ void store_k_quad(float (*buf)[kBigRow], int l0,
                                             int r, float4 v) {
  buf[l0 + 0][r] = v.x;
  buf[l0 + 1][r] = v.y;
  buf[l0 + 2][r] = v.z;
  buf[l0 + 3][r] = v.w;
}

// `valid` leading values of four neighbours in a row of B (valid <= 0: none).
__device__ __forceinline__ float4 load_row_quad(const float* src, int valid,
                                                bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && valid >= kQuad) {
    v = *reinterpret_cast<const float4*>(src);
  } else {
    if (valid > 0) v.x = src[0];
    if (valid > 1) v.y = src[1];
    if (valid > 2) v.z = src[2];
    if (valid > 3) v.w = src[3];
  }
  return v;
}

__device__ __forceinline__ void store_row_quad(float* dst, float4 v,
                                               int valid, bool vec) {
  if (vec && valid >= kQuad) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    if (valid > 0) dst[0] = v.x;
    if (valid > 1) dst[1] = v.y;
    if (valid > 2) dst[2] = v.z;
    if (valid > 3) dst[3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
sub_matmul_kernel_f32_128(int m, int n, int k,
                          const float* b, long long ldb,
                          const float* __restrict__ p, long long ldp,
                          const float* __restrict__ q, long long ldq,
                          float* out, long long ldo) {
  // ps[buf][l][r] = P[row0 + r, k0 + l];  qs[buf][l][c] = Q[col0 + c, k0 + l]
  __shared__ __align__(16) float ps[2][kBigSlice][kBigRow];
  __shared__ __align__(16) float qs[2][kBigSlice][kBigRow];

  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  const int row0 = blockIdx.y * kBigTile;
  const int col0 = blockIdx.x * kBigTile;
  // staging: in pass e this thread brings row sr0 + e * kPassRows of the P
  // tile and of the Q tile, the k-quad starting at sl of the slice
  const int sr0 = t / kRowQuads;
  const int sl = (t % kRowQuads) * kQuad;
  const bool pvec = aligned16(p) && ldp % kQuad == 0;
  const bool qvec = aligned16(q) && ldq % kQuad == 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int slices = (k + kBigSlice - 1) / kBigSlice;
  if (slices > 0) {
#pragma unroll
    for (int e = 0; e < kStage; ++e) {
      const int sr = sr0 + e * kPassRows;
      store_k_quad(ps[0], sl, sr,
                   load_k_quad(p, ldp, row0 + sr, m, sl, k, pvec));
      store_k_quad(qs[0], sl, sr,
                   load_k_quad(q, ldq, col0 + sr, n, sl, k, qvec));
    }
  }
  __syncthreads();

  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    float4 pnext[kStage], qnext[kStage];
    if (more) {
      const int k0 = (s + 1) * kBigSlice + sl;
#pragma unroll
      for (int e = 0; e < kStage; ++e) {
        const int sr = sr0 + e * kPassRows;
        pnext[e] = load_k_quad(p, ldp, row0 + sr, m, k0, k, pvec);
        qnext[e] = load_k_quad(q, ldq, col0 + sr, n, k0, k, qvec);
      }
    }
#pragma unroll
    for (int l = 0; l < kBigSlice; ++l) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&ps[cur][l][ty * kQuad]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&ps[cur][l][kHalf + ty * kQuad]);
      const float4 c0 =
          *reinterpret_cast<const float4*>(&qs[cur][l][tx * kQuad]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&qs[cur][l][kHalf + tx * kQuad]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    if (more) {
#pragma unroll
      for (int e = 0; e < kStage; ++e) {
        const int sr = sr0 + e * kPassRows;
        store_k_quad(ps[cur ^ 1], sl, sr, pnext[e]);
        store_k_quad(qs[cur ^ 1], sl, sr, qnext[e]);
      }
    }
    __syncthreads();
  }

  // acc[hi * 4 + i][hj * 4 + j] belongs to row row0 + hi*64 + ty*4 + i and
  // column col0 + hj*64 + tx*4 + j.  For each i the four quads of B are read
  // before the first is written: OUT may be B.
  const bool ovec = aligned16(b) && aligned16(out) && ldb % kQuad == 0 &&
                    ldo % kQuad == 0;
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    float4 bv[2][2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int gr = row0 + hi * kHalf + ty * kQuad + i;
#pragma unroll
      for (int hj = 0; hj < 2; ++hj) {
        const int gc = col0 + hj * kHalf + tx * kQuad;
        const int valid = gr < m ? n - gc : 0;
        bv[hi][hj] = load_row_quad(
            b + static_cast<long long>(gr) * ldb + gc, valid, ovec);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int gr = row0 + hi * kHalf + ty * kQuad + i;
#pragma unroll
      for (int hj = 0; hj < 2; ++hj) {
        const int gc = col0 + hj * kHalf + tx * kQuad;
        const int valid = gr < m ? n - gc : 0;
        const int ai = hi * kQuad + i;
        const int aj = hj * kQuad;
        const float4 v = make_float4(bv[hi][hj].x - acc[ai][aj + 0],
                                     bv[hi][hj].y - acc[ai][aj + 1],
                                     bv[hi][hj].z - acc[ai][aj + 2],
                                     bv[hi][hj].w - acc[ai][aj + 3]);
        store_row_quad(out + static_cast<long long>(gr) * ldo + gc, v, valid,
                       ovec);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f64, 128 x 64 tile a block, on the FP64 tensor cores
// ---------------------------------------------------------------------------

constexpr int kDTileM = 128;                     // output rows of a block
constexpr int kDTileN = 64;                      // output columns of a block
constexpr int kDSlice = 8;                       // K-slice: two k steps of 4
constexpr int kDWarpsM = 4;                      // warps along the rows
constexpr int kDWarpsN = kThreads / 32 / kDWarpsM;
constexpr int kDFragM = kDTileM / kDWarpsM / 8;  // 8 x 8 fragments of a warp
constexpr int kDFragN = kDTileN / kDWarpsN / 8;
constexpr int kDBlocksPerSm = 2;                 // __launch_bounds__' minimum
// staging: a slice of an operand tile is rows of four (row, t) pairs, each
// pair the two k steps of fragment column t; one pass of the block covers
// kDPassRows rows
constexpr int kDPassRows = kThreads / 4;
constexpr int kDStageP = kDTileM / kDPassRows;
constexpr int kDStageQ = kDTileN / kDPassRows;
static_assert(kDSlice == 8, "a pair holds the slice's two k steps");
static_assert(kDStageP * kDPassRows == kDTileM &&
              kDStageQ * kDPassRows == kDTileN, "whole passes");
static_assert(kDFragM * 8 * kDWarpsM == kDTileM &&
              kDFragN * 8 * kDWarpsN == kDTileN, "whole fragments");
static_assert(2 * kDSlice * (kDTileM + kDTileN) * 8 <= 48 * 1024,
              "static shared memory");

// D = A * B + D on one warp's 8 x 8 x 4 f64 fragments (DMMA, full IEEE f64,
// round to nearest).  Lane = g * 4 + t holds A[g][t], B[t][g], and D[g][2t],
// D[g][2t + 1] in c.
__device__ __forceinline__ void dmma_m8n8k4(double (&c)[2], double a,
                                            double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
}

// Operand row `row`, columns kt and kt + 4: the two k steps of fragment
// column t = kt - k0 of a slice; zero for a row >= rows and past k.
__device__ __forceinline__ double2 load_k_steps(const double* __restrict__ base,
                                                long long ld, int row,
                                                int rows, int kt, int k) {
  double2 v = make_double2(0.0, 0.0);
  if (row < rows) {
    const double* src = base + static_cast<long long>(row) * ld;
    if (kt < k) v.x = src[kt];
    if (kt + 4 < k) v.y = src[kt + 4];
  }
  return v;
}

// `valid` leading values of two neighbours in a row of B (valid <= 0: none).
__device__ __forceinline__ double2 load_row_pair(const double* src, int valid,
                                                 bool vec) {
  double2 v = make_double2(0.0, 0.0);
  if (vec && valid >= 2) {
    v = *reinterpret_cast<const double2*>(src);
  } else {
    if (valid > 0) v.x = src[0];
    if (valid > 1) v.y = src[1];
  }
  return v;
}

__device__ __forceinline__ void store_row_pair(double* dst, double2 v,
                                               int valid, bool vec) {
  if (vec && valid >= 2) {
    *reinterpret_cast<double2*>(dst) = v;
  } else {
    if (valid > 0) dst[0] = v.x;
    if (valid > 1) dst[1] = v.y;
  }
}

__global__ void __launch_bounds__(kThreads, kDBlocksPerSm)
sub_matmul_kernel_f64_dmma(int m, int n, int k,
                           const double* b, long long ldb,
                           const double* __restrict__ p, long long ldp,
                           const double* __restrict__ q, long long ldq,
                           double* out, long long ldo) {
  // ps[buf][r][t] = (P[row0 + r, k0 + t], P[row0 + r, k0 + 4 + t]),
  // qs[buf][c][t] likewise for Q[col0 + c]: a row of a slice is 64
  // contiguous bytes, so a warp's fragment loads and staging stores each
  // cover 512 contiguous bytes
  __shared__ __align__(16) double2 ps[2][kDTileM][4];
  __shared__ __align__(16) double2 qs[2][kDTileN][4];

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int g = lane / 4;   // fragment row of A and D, column of B
  const int tk = lane % 4;  // fragment column of A, row of B; D's pair
  const int wr = (warp / kDWarpsN) * kDFragM * 8;  // the warp's rows
  const int wc = (warp % kDWarpsN) * kDFragN * 8;  // and columns in the tile
  const int row0 = blockIdx.y * kDTileM;
  const int col0 = blockIdx.x * kDTileN;
  // staging: in pass e this thread brings the pair st of row
  // sr0 + e * kDPassRows of the P tile and of the Q tile
  const int sr0 = t / 4;
  const int st = t % 4;

  // acc[i][j] = D[g][2tk], D[g][2tk + 1] of fragment (i, j): rows
  // wr + 8i + g, columns wc + 8j + 2tk, + 1
  double acc[kDFragM][kDFragN][2];
#pragma unroll
  for (int i = 0; i < kDFragM; ++i)
#pragma unroll
    for (int j = 0; j < kDFragN; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  const int slices = (k + kDSlice - 1) / kDSlice;
  if (slices > 0) {
#pragma unroll
    for (int e = 0; e < kDStageP; ++e) {
      const int sr = sr0 + e * kDPassRows;
      ps[0][sr][st] = load_k_steps(p, ldp, row0 + sr, m, st, k);
    }
#pragma unroll
    for (int e = 0; e < kDStageQ; ++e) {
      const int sr = sr0 + e * kDPassRows;
      qs[0][sr][st] = load_k_steps(q, ldq, col0 + sr, n, st, k);
    }
  }
  __syncthreads();

  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    double2 pnext[kDStageP], qnext[kDStageQ];
    if (more) {
      const int kt = (s + 1) * kDSlice + st;
#pragma unroll
      for (int e = 0; e < kDStageP; ++e)
        pnext[e] = load_k_steps(p, ldp, row0 + sr0 + e * kDPassRows, m, kt, k);
#pragma unroll
      for (int e = 0; e < kDStageQ; ++e)
        qnext[e] = load_k_steps(q, ldq, col0 + sr0 + e * kDPassRows, n, kt, k);
    }
    double2 a[kDFragM], c[kDFragN];
#pragma unroll
    for (int i = 0; i < kDFragM; ++i) a[i] = ps[cur][wr + i * 8 + g][tk];
#pragma unroll
    for (int j = 0; j < kDFragN; ++j) c[j] = qs[cur][wc + j * 8 + g][tk];
    // the slice's two k steps in ascending order
#pragma unroll
    for (int i = 0; i < kDFragM; ++i)
#pragma unroll
      for (int j = 0; j < kDFragN; ++j) dmma_m8n8k4(acc[i][j], a[i].x, c[j].x);
#pragma unroll
    for (int i = 0; i < kDFragM; ++i)
#pragma unroll
      for (int j = 0; j < kDFragN; ++j) dmma_m8n8k4(acc[i][j], a[i].y, c[j].y);
    if (more) {
#pragma unroll
      for (int e = 0; e < kDStageP; ++e)
        ps[cur ^ 1][sr0 + e * kDPassRows][st] = pnext[e];
#pragma unroll
      for (int e = 0; e < kDStageQ; ++e)
        qs[cur ^ 1][sr0 + e * kDPassRows][st] = qnext[e];
    }
    __syncthreads();
  }

  // For each row of fragments the pairs of B are read before the first is
  // written: OUT may be B.
  const bool ovec = aligned16(b) && aligned16(out) && ldb % 2 == 0 &&
                    ldo % 2 == 0;
#pragma unroll
  for (int i = 0; i < kDFragM; ++i) {
    const int gr = row0 + wr + i * 8 + g;
    double2 bv[kDFragN];
#pragma unroll
    for (int j = 0; j < kDFragN; ++j) {
      const int gc = col0 + wc + j * 8 + 2 * tk;
      bv[j] = load_row_pair(b + static_cast<long long>(gr) * ldb + gc,
                            gr < m ? n - gc : 0, ovec);
    }
#pragma unroll
    for (int j = 0; j < kDFragN; ++j) {
      const int gc = col0 + wc + j * 8 + 2 * tk;
      store_row_pair(out + static_cast<long long>(gr) * ldo + gc,
                     make_double2(bv[j].x - acc[i][j][0],
                                  bv[j].y - acc[i][j][1]),
                     gr < m ? n - gc : 0, ovec);
    }
  }
}

// ---------------------------------------------------------------------------
// The launch rule
// ---------------------------------------------------------------------------

// Number of SMs of the current device, read once: every card of one host is
// taken to be alike.  (cudaGetDeviceProperties costs more than a launch.)
int sm_count() {
  static const int sms = [] {
    int device = 0, value = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&value, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess) {
      (void)cudaGetLastError();
      return 0;
    }
    return value;
  }();
  return sms;
}

constexpr long long kBigTilesPerSm = 1;  // the f32 rule's factor

int launch(int m, int n, int k, const float* b, long long ldb, const float* p,
           long long ldp, const float* q, long long ldq, float* out,
           long long ldo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 big((n + kBigTile - 1) / kBigTile, (m + kBigTile - 1) / kBigTile);
  const int sms = sm_count();
  if (sms > 0 &&
      static_cast<long long>(big.x) * big.y >= kBigTilesPerSm * sms) {
    sub_matmul_kernel_f32_128<<<big, kThreads, 0, s>>>(
        m, n, k, b, ldb, p, ldp, q, ldq, out, ldo);
  } else {
    const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
    sub_matmul_kernel<<<grid, kThreads, 0, s>>>(m, n, k, b, ldb, p, ldp, q,
                                                ldq, out, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch(int m, int n, int k, const double* b, long long ldb,
           const double* p, long long ldp, const double* q, long long ldq,
           double* out, long long ldo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kDTileN - 1) / kDTileN, (m + kDTileM - 1) / kDTileM);
  sub_matmul_kernel_f64_dmma<<<grid, kThreads, 0, s>>>(
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
  return launch(m, n, k, b, ldb, p, ldp, q, ldq, out, ldo, stream);
}

extern "C" int eigenexa_sub_matmul_f64(int m, int n, int k, const double* b,
                                       long long ldb, const double* p,
                                       long long ldp, const double* q,
                                       long long ldq, double* out,
                                       long long ldo, void* stream) {
  return launch(m, n, k, b, ldb, p, ldp, q, ldq, out, ldo, stream);
}

// Window entry points: B is (m, m), P and Q are (m, k), and only rows and
// columns >= w take part: B[w:, w:] -= P[w:] * Q[w:]^T, in place.
extern "C" int eigenexa_sub_matmul_window_f32(int m, int w, int k, float* b,
                                              long long ldb, const float* p,
                                              long long ldp, const float* q,
                                              long long ldq, void* stream) {
  float* win = b + w * ldb + w;
  return launch(m - w, m - w, k, win, ldb, p + w * ldp, ldp,
                q + w * ldq, ldq, win, ldb, stream);
}

extern "C" int eigenexa_sub_matmul_window_f64(int m, int w, int k, double* b,
                                              long long ldb, const double* p,
                                              long long ldp, const double* q,
                                              long long ldq, void* stream) {
  double* win = b + w * ldb + w;
  return launch(m - w, m - w, k, win, ldb, p + w * ldp, ldp,
                q + w * ldq, ldq, win, ldb, stream);
}
