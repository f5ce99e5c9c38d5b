// OUT = B - P * Q^T with the subtract fused into the product: one pass over B
// (OUT = B - P * Q^H for the complex entry points).
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
// The complex entry points (eigenexa_sub_matmul_c64, _c128) serve the
// Hermitian driver eigen_h: its rolled reduction's rank-2k updates and its
// back-transform blocks, k = 128, in place.  On the TPU complex never reached
// Pallas (`_shape_eligible` sent it to `b - p @ conj(q).T`); here each
// complex type has two kernels and a launch rule like the f32 one, all four
// summing the same real fma chains (the block comment above them), so both
// kernels of a type give the same bits.  A complex multiply-add is 8 real
// operations, so at k = 128 both types are bound by operations: 8128^2 x 128
// takes 1.01 ms at 67 TFLOP/s, against 0.32 ms (c64) and 0.63 ms (c128) of
// bytes; c128's FP64 work outside the tensor cores would take 2.0 ms.
//   * c64: `sub_matmul_kernel_c64_wide`, the f32 128-tile kernel's design on
//     complex values (64 x 128 complex tiles, a 4 x 8 micro-tile a thread,
//     16-byte shared reads, register double buffering), where its tiles
//     fill the SMs; `sub_matmul_kernel_c64`, the 64 x 64-tile kernel,
//     below that (the late, small trailing updates);
//   * c128: `sub_matmul_kernel_c128_ring`, 64 x 64 complex tiles on DMMA fed
//     by a 4-stage cp.async ring of raw P and Q slices, where its tiles fill
//     the SMs and the operands are 16-byte aligned; the 64 x 64-tile
//     kernel `sub_matmul_kernel_c128` (register-staged slices) below that.
// Measured (chip_smoke.py and tools/kernel_variants.py --sweep-complex,
// NVIDIA H100 80GB HBM3, 700.00 W), rank-2k 8128^2 x 128 device time:
// c64 1.79 ms (the 64-tile kernel) -> 1.59-1.60 ms, against 1.35-1.36 ms for
// torch.addmm(b, p, q.conj().T, alpha=-1); c128 2.75 -> 1.81 ms, against
// 1.84-1.91 ms.  Both rules take the larger-tile kernel once the 64-tile one
// would have at least one 64 x 64 tile for each SM (a square of m >= 705 on
// 132 SMs): for c64 that is where the sweep crosses, for c128 the ring is
// faster at every size (see `launch`).  Below m = 1024 a call costs the
// host's launch interval whichever kernel runs.
//
// As built (nvcc -O3 for sm_90a; `python3 chip_smoke.py --kernels` prints
// ptxas's figures): the 128-tile kernel takes 126 registers a thread, 0 bytes
// of spill and 33,792 bytes of static shared memory a block; the 64-tile
// kernel 40 registers and 8,320 bytes; the DMMA kernel 128 registers and
// 24,576 bytes; the c64 kernels 128 registers and 25,088 bytes (64 x 128)
// and 64 registers and 8,320 bytes (64 x 64); the c128 kernels 128
// registers and 65,536 bytes of dynamic shared memory (the ring) and 122
// registers and 16,384 bytes; none spills.
//
// Later work, not here: asynchronous staging (cp.async or TMA) for the real
// kernels, so that the loads and the epilogue's read run under the FMAs and
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

__host__ __device__ __forceinline__ bool aligned16(const void* ptr) {
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

// D = A * B + D on one warp's 16 x 8 x 4 f64 fragments: the two 8 x 8 x 4
// products of rows g and g + 8 that share B, in one instruction.  Lane
// g * 4 + t holds A[g][t] in a_lo, A[g + 8][t] in a_hi, B[t][g], and
// D[g][2t], D[g][2t + 1] in lo, D[g + 8][2t], D[g + 8][2t + 1] in hi.  On
// an H100 this shape issues at twice m8n8k4's rate (65 against 33 TFLOP/s,
// tools/dmma_rate.py), and both give the bits of the fma chain over k.
__device__ __forceinline__ void dmma_m16n8k4(double (&lo)[2], double (&hi)[2],
                                             double a_lo, double a_hi,
                                             double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
               : "+d"(lo[0]), "+d"(lo[1]), "+d"(hi[0]), "+d"(hi[1])
               : "d"(a_lo), "d"(a_hi), "d"(b));
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
// complex: OUT = B - P * Q^H, c64 and c128
// ---------------------------------------------------------------------------
//
// A complex value is its interleaved (re, im) storage read as one float2 or
// double2, and the conjugate of Q is taken where a Q value is loaded,
// C = conj(Q) = (qr, -qi), never as a copy.  Each output is then two real
// chains of fma over the 2k real terms of its row, in ascending order:
//   re: + pr * cr, - pi * ci    (= pr * qr + pi * qi)
//   im: + pi * cr, + pr * ci    (= pi * qr - pr * qi)
// the real products [Pr -Pi] . [Cr Ci]^T and [Pi Pr] . [Cr Ci]^T of depth 2k,
// which share the conjugated Q tile.  A negated factor is exact, so these are
// the bits of the same chains written over Q itself.  Every kernel below
// takes the conjugate's sign through `conj_part`.

// A real part of conj(Q): the imaginary part negated.
template <typename T>
__device__ __forceinline__ T conj_part(T x, bool imaginary) {
  return imaginary ? -x : x;
}

template <typename V>
__device__ __forceinline__ V conj_value(V v) {
  v.y = conj_part(v.y, true);
  return v;
}

// base[row * ld + col], zero for a row >= rows or a column >= cols.
template <typename V>
__device__ __forceinline__ V load_value(const V* __restrict__ base,
                                        long long ld, int row, int rows,
                                        int col, int cols) {
  if (row < rows && col < cols) return base[row * ld + col];
  V zero;
  zero.x = 0;
  zero.y = 0;
  return zero;
}

// c64, the 64-tile kernel, for the launches too small to give each SM a
// 64 x 128 tile of `sub_matmul_kernel_c64_wide` (the late trailing updates
// of a reduction): the 64-tile kernel's layout on complex values.  A 64 x 64
// tile a block, 256 threads, a 4 x 4 micro-tile of complex outputs each (32
// float accumulators), complex K-slices of 8 staged in shared memory.  A k
// step reads 8 float2 from shared memory for 64 FMAs.
constexpr int kCTile = 64;               // complex outputs along a tile edge
constexpr int kCSlice = 8;               // complex K-slice
constexpr int kCMicro = kCTile / kSide;  // 4 x 4 outputs a thread

__global__ void __launch_bounds__(kThreads)
sub_matmul_kernel_c64(int m, int n, int k,
                      const float2* b, long long ldb,
                      const float2* __restrict__ p, long long ldp,
                      const float2* __restrict__ q, long long ldq,
                      float2* out, long long ldo) {
  // ps[l][r] = P[row0 + r, k0 + l];  cs[l][c] = conj(Q[col0 + c, k0 + l])
  __shared__ float2 ps[kCSlice][kCTile + 1];
  __shared__ float2 cs[kCSlice][kCTile + 1];

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * kCTile;
  const int col0 = blockIdx.x * kCTile;

  float re[kCMicro][kCMicro], im[kCMicro][kCMicro];
#pragma unroll
  for (int i = 0; i < kCMicro; ++i)
#pragma unroll
    for (int j = 0; j < kCMicro; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kCSlice) {
    for (int e = threadIdx.x; e < kCTile * kCSlice; e += kThreads) {
      const int r = e / kCSlice;
      const int l = e % kCSlice;
      ps[l][r] = load_value(p, ldp, row0 + r, m, k0 + l, k);
      cs[l][r] = conj_value(load_value(q, ldq, col0 + r, n, k0 + l, k));
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < kCSlice; ++l) {
      float2 a[kCMicro], c[kCMicro];
#pragma unroll
      for (int i = 0; i < kCMicro; ++i) a[i] = ps[l][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kCMicro; ++j) c[j] = cs[l][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kCMicro; ++i)
#pragma unroll
        for (int j = 0; j < kCMicro; ++j) {
          re[i][j] = fmaf(a[i].x, c[j].x, re[i][j]);
          re[i][j] = fmaf(-a[i].y, c[j].y, re[i][j]);
          im[i][j] = fmaf(a[i].y, c[j].x, im[i][j]);
          im[i][j] = fmaf(a[i].x, c[j].y, im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kCMicro; ++i) {
    const int gr = row0 + ty + kSide * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kCMicro; ++j) {
      const int gc = col0 + tx + kSide * j;
      if (gc < n) {
        const float2 bv = b[gr * ldb + gc];
        out[gr * ldo + gc] = make_float2(bv.x - re[i][j], bv.y - im[i][j]);
      }
    }
  }
}

// c128 on the FP64 tensor cores, the 64-tile kernel, for the launches too
// small to give each SM a tile of `sub_matmul_kernel_c128_ring` (and for
// operands not 16-byte aligned): a 64 x 64 tile of complex outputs a block,
// 8 warps in 4 x 2, each warp 16 x 32 outputs as 2 x 4 DMMA fragments of
// 8 x 8 with a real and an imaginary accumulator (32 doubles a thread, as the
// f64 kernel).  A DMMA k step of 4 real terms is two complex k: lane
// g * 4 + t takes complex k t / 2 of its step, its real part for even t and
// its imaginary part for odd t, so the A operand of the real accumulator is
// (pr, -pi, ...) and that of the imaginary one (pi, pr, ...) against the
// same B operand (cr, ci, ...) of the conjugated Q.  Complex K-slices of 4
// (two k steps) are double-buffered through registers, one value of P and
// one of Q a thread.
constexpr int kZTile = 64;                       // complex outputs a tile edge
constexpr int kZSlice = 4;                       // complex K-slice: 2 k steps
constexpr int kZWarpsM = 4;                      // warps along the rows
constexpr int kZWarpsN = kThreads / 32 / kZWarpsM;
constexpr int kZFragM = kZTile / kZWarpsM / 8;   // 8 x 8 fragments of a warp
constexpr int kZFragN = kZTile / kZWarpsN / 8;
static_assert(kZTile * kZSlice == kThreads, "one staged value a thread");
static_assert(kZFragM * 8 * kZWarpsM == kZTile &&
              kZFragN * 8 * kZWarpsN == kZTile, "whole fragments");

__global__ void __launch_bounds__(kThreads, kDBlocksPerSm)
sub_matmul_kernel_c128(int m, int n, int k,
                       const double2* b, long long ldb,
                       const double2* __restrict__ p, long long ldp,
                       const double2* __restrict__ q, long long ldq,
                       double2* out, long long ldo) {
  // ps[buf][r][l] = P[row0 + r, k0 + l];  cs[buf][c][l] = conj(Q[col0 + c,
  // k0 + l]): a row of a slice is 64 contiguous bytes
  __shared__ __align__(16) double2 ps[2][kZTile][kZSlice];
  __shared__ __align__(16) double2 cs[2][kZTile][kZSlice];

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int g = lane / 4;          // fragment row of A and D, column of B
  const int tk = lane % 4;         // real k of a step; D's pair
  const int half = tk / 2;         // the complex k of the step it belongs to
  const bool odd = tk % 2 != 0;    // its imaginary part
  const int wr = (warp / kZWarpsN) * kZFragM * 8;  // the warp's rows
  const int wc = (warp % kZWarpsN) * kZFragN * 8;  // and columns in the tile
  const int row0 = blockIdx.y * kZTile;
  const int col0 = blockIdx.x * kZTile;
  // staging: this thread brings value sl of row sr of each slice's P and Q
  const int sr = t / kZSlice;
  const int sl = t % kZSlice;

  // re[i][j], im[i][j] = D[g][2tk], D[g][2tk + 1] of fragment (i, j): rows
  // wr + 8i + g, columns wc + 8j + 2tk, + 1
  double re[kZFragM][kZFragN][2], im[kZFragM][kZFragN][2];
#pragma unroll
  for (int i = 0; i < kZFragM; ++i)
#pragma unroll
    for (int j = 0; j < kZFragN; ++j)
      re[i][j][0] = re[i][j][1] = im[i][j][0] = im[i][j][1] = 0.0;

  const int slices = (k + kZSlice - 1) / kZSlice;
  if (slices > 0) {
    ps[0][sr][sl] = load_value(p, ldp, row0 + sr, m, sl, k);
    cs[0][sr][sl] = conj_value(load_value(q, ldq, col0 + sr, n, sl, k));
  }
  __syncthreads();

  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    double2 pnext, cnext;
    if (more) {
      const int kk = (s + 1) * kZSlice + sl;
      pnext = load_value(p, ldp, row0 + sr, m, kk, k);
      cnext = conj_value(load_value(q, ldq, col0 + sr, n, kk, k));
    }
    // the slice's two k steps in ascending order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double ar[kZFragM], ai[kZFragM], c[kZFragN];
#pragma unroll
      for (int i = 0; i < kZFragM; ++i) {
        const double2 v = ps[cur][wr + i * 8 + g][2 * h + half];
        ar[i] = odd ? -v.y : v.x;
        ai[i] = odd ? v.x : v.y;
      }
#pragma unroll
      for (int j = 0; j < kZFragN; ++j) {
        const double2 v = cs[cur][wc + j * 8 + g][2 * h + half];
        c[j] = odd ? v.y : v.x;
      }
#pragma unroll
      for (int i = 0; i < kZFragM; ++i)
#pragma unroll
        for (int j = 0; j < kZFragN; ++j) dmma_m8n8k4(re[i][j], ar[i], c[j]);
#pragma unroll
      for (int i = 0; i < kZFragM; ++i)
#pragma unroll
        for (int j = 0; j < kZFragN; ++j) dmma_m8n8k4(im[i][j], ai[i], c[j]);
    }
    if (more) {
      ps[cur ^ 1][sr][sl] = pnext;
      cs[cur ^ 1][sr][sl] = cnext;
    }
    __syncthreads();
  }

  // each output is read from B and written by the same lane: OUT may be B
#pragma unroll
  for (int i = 0; i < kZFragM; ++i) {
    const int gr = row0 + wr + i * 8 + g;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kZFragN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = col0 + wc + j * 8 + 2 * tk + e;
        if (gc < n) {
          const double2 bv = b[gr * ldb + gc];
          out[gr * ldo + gc] =
              make_double2(bv.x - re[i][j][e], bv.y - im[i][j][e]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// c64, 64 x 128 complex tile a block: the f32 128-tile kernel's design
// ---------------------------------------------------------------------------
//
// 256 threads as 16 x 16; a thread keeps a 4 x 8 micro-tile of complex
// outputs (64 float accumulators): rows 32p + 2ty + {0, 1} (p = 0, 1) and
// columns 32q + 2tx + {0, 1} (q = 0..3), so every read of a k step is one
// 16-byte vector of two neighbouring complex values: 2 of P and 4 of conj(Q)
// for 128 FMAs.  In a warp the P reads are broadcasts (two values of ty) and
// a quarter warp's Q reads cover 128 contiguous bytes: no bank conflict.
// Complex K-slices of 8 are double-buffered through registers (one 16-byte
// global load of P and two of Q a thread, two complex values each), stored
// k-major into rows padded by two values (16-byte aligned for the reads; the
// transposing 8-byte stores of a half warp land on distinct banks), one
// barrier a slice; two blocks an SM.  The epilogue reads B and writes OUT
// 16 bytes (two complex values) a thread where the addresses allow.  The
// four fma of each (i, j, l) are the 64-tile kernel's, in its order, over the
// same values.
//
// Measured (tools/kernel_variants.py --sweep-complex, NVIDIA H100 80GB
// HBM3, 700.00 W), 8128^2 x 128: 1.59-1.60 ms of device time, 63% of the
// 1.01 ms bound, against 1.35-1.36 ms for torch.addmm and 1.79 ms for the
// 64-tile kernel.  Copies with a part taken out: without B's read 1.58 ms;
// with the imaginary chain's FMAs dropped (half the FMAs) 1.17 ms, a saving
// of 0.42 ms of the 0.50 ms those FMAs take at the pipes' peak.  So the FMAs
// hide little of the rest of the loop (shared-memory reads with four warps
// a scheduler, the staging, a barrier a slice).  One block an SM (135
// registers) took 1.84 ms.
constexpr int kC2TileM = 64;              // complex output rows of a block
constexpr int kC2TileN = 128;             // complex output columns
constexpr int kC2Slice = 8;               // complex K-slice
constexpr int kC2RowP = kC2TileM + 2;     // padded k-major row, complex
constexpr int kC2RowQ = kC2TileN + 2;
constexpr long long kC2TilesPerSm = 1;    // the c64 rule's factor (64-tiles)
constexpr int kC2BlocksPerSm = 2;         // __launch_bounds__' minimum
// staging: a slice of an operand tile is rows of four 16-byte pairs
constexpr int kC2PassRows = kThreads / (kC2Slice / 2);
constexpr int kC2StageP = kC2TileM / kC2PassRows;
constexpr int kC2StageQ = kC2TileN / kC2PassRows;
static_assert(kC2StageP * kC2PassRows == kC2TileM &&
              kC2StageQ * kC2PassRows == kC2TileN, "whole passes");
static_assert(kC2TileM == 64 && kC2TileN == 128, "the micro-tile's map");

// Complex values k0 and k0 + 1 (k0 even) of row `row` of an operand as one
// float4; zero for a row >= rows and for columns >= k.
__device__ __forceinline__ float4 load_c_pair(const float2* base, long long ld,
                                              int row, int rows, int k0,
                                              int k, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows && k0 < k) {
    const float2* src = base + static_cast<long long>(row) * ld + k0;
    if (vec && k0 + 2 <= k) {
      v = *reinterpret_cast<const float4*>(src);
    } else {
      v.x = src[0].x;
      v.y = src[0].y;
      if (k0 + 1 < k) {
        v.z = src[1].x;
        v.w = src[1].y;
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, kC2BlocksPerSm)
sub_matmul_kernel_c64_wide(int m, int n, int k,
                           const float2* b, long long ldb,
                           const float2* __restrict__ p, long long ldp,
                           const float2* __restrict__ q, long long ldq,
                           float2* out, long long ldo) {
  // ps[buf][l][r] = P[row0 + r, k0 + l];  cs[buf][l][c] = conj(Q[col0 + c,
  // k0 + l])
  __shared__ __align__(16) float2 ps[2][kC2Slice][kC2RowP];
  __shared__ __align__(16) float2 cs[2][kC2Slice][kC2RowQ];

  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  const int row0 = blockIdx.y * kC2TileM;
  const int col0 = blockIdx.x * kC2TileN;
  // staging: in pass e this thread brings the pair sl, sl + 1 of row
  // sr0 + e * kC2PassRows of the P tile and of the Q tile
  const int sr0 = t / (kC2Slice / 2);
  const int sl = (t % (kC2Slice / 2)) * 2;
  const bool pvec = aligned16(p) && ldp % 2 == 0;
  const bool qvec = aligned16(q) && ldq % 2 == 0;

  float re[4][8], im[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) re[i][j] = im[i][j] = 0.f;

  // the transposing stores of one staged pair; Q's conjugate is taken here
  auto store_p = [&](int buf, int r, float4 v) {
    ps[buf][sl][r] = make_float2(v.x, v.y);
    ps[buf][sl + 1][r] = make_float2(v.z, v.w);
  };
  auto store_c = [&](int buf, int r, float4 v) {
    cs[buf][sl][r] = conj_value(make_float2(v.x, v.y));
    cs[buf][sl + 1][r] = conj_value(make_float2(v.z, v.w));
  };

  const int slices = (k + kC2Slice - 1) / kC2Slice;
  if (slices > 0) {
#pragma unroll
    for (int e = 0; e < kC2StageP; ++e) {
      const int sr = sr0 + e * kC2PassRows;
      store_p(0, sr, load_c_pair(p, ldp, row0 + sr, m, sl, k, pvec));
    }
#pragma unroll
    for (int e = 0; e < kC2StageQ; ++e) {
      const int sr = sr0 + e * kC2PassRows;
      store_c(0, sr, load_c_pair(q, ldq, col0 + sr, n, sl, k, qvec));
    }
  }
  __syncthreads();

  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    float4 pnext[kC2StageP], qnext[kC2StageQ];
    if (more) {
      const int k0 = (s + 1) * kC2Slice + sl;
#pragma unroll
      for (int e = 0; e < kC2StageP; ++e)
        pnext[e] = load_c_pair(p, ldp, row0 + sr0 + e * kC2PassRows, m, k0,
                               k, pvec);
#pragma unroll
      for (int e = 0; e < kC2StageQ; ++e)
        qnext[e] = load_c_pair(q, ldq, col0 + sr0 + e * kC2PassRows, n, k0,
                               k, qvec);
    }
#pragma unroll
    for (int l = 0; l < kC2Slice; ++l) {
      float2 a[4], c[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(&ps[cur][l][32 * h + 2 * ty]);
        a[2 * h] = make_float2(v.x, v.y);
        a[2 * h + 1] = make_float2(v.z, v.w);
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(&cs[cur][l][32 * h + 2 * tx]);
        c[2 * h] = make_float2(v.x, v.y);
        c[2 * h + 1] = make_float2(v.z, v.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          re[i][j] = fmaf(a[i].x, c[j].x, re[i][j]);
          re[i][j] = fmaf(-a[i].y, c[j].y, re[i][j]);
          im[i][j] = fmaf(a[i].y, c[j].x, im[i][j]);
          im[i][j] = fmaf(a[i].x, c[j].y, im[i][j]);
        }
    }
    if (more) {
#pragma unroll
      for (int e = 0; e < kC2StageP; ++e)
        store_p(cur ^ 1, sr0 + e * kC2PassRows, pnext[e]);
#pragma unroll
      for (int e = 0; e < kC2StageQ; ++e)
        store_c(cur ^ 1, sr0 + e * kC2PassRows, qnext[e]);
    }
    __syncthreads();
  }

  // re[2h + a][2q + e] belongs to row row0 + 32h + 2ty + a and column
  // col0 + 32q + 2tx + e.  For each row the four pairs of B are read before
  // the first is written: OUT may be B.
  const bool ovec = aligned16(b) && aligned16(out) && ldb % 2 == 0 &&
                    ldo % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + 32 * (i / 2) + 2 * ty + i % 2;
    if (gr >= m) continue;
    float4 bv[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int gc = col0 + 32 * h + 2 * tx;
      bv[h] = load_c_pair(b, ldb, gr, m, gc, n, ovec);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int gc = col0 + 32 * h + 2 * tx;
      const float4 v = make_float4(
          bv[h].x - re[i][2 * h], bv[h].y - im[i][2 * h],
          bv[h].z - re[i][2 * h + 1], bv[h].w - im[i][2 * h + 1]);
      float2* dst = out + static_cast<long long>(gr) * ldo + gc;
      if (ovec && gc + 2 <= n) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        if (gc < n) dst[0] = make_float2(v.x, v.y);
        if (gc + 1 < n) dst[1] = make_float2(v.z, v.w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// c128, a ring of cp.async stages feeding DMMA
// ---------------------------------------------------------------------------
//
// A 64 x 64 tile of complex outputs a block, 8 warps in 4 x 2, each warp
// 16 x 32 outputs as 2 x 4 DMMA fragments of 8 x 8 with a real and an
// imaginary accumulator (32 doubles a thread), two blocks an SM.  The k step
// is the 64-tile kernel's: lane g * 4 + t takes complex k t / 2 of its step,
// its real part for even t and its imaginary part for odd t, A = (pr, -pi)
// for the real accumulator and (pi, pr) for the imaginary one, B = (cr, ci)
// of C = conj(Q): the same operands in the same order, so the same bits.  The
// two 8-row fragments of a warp take one m16n8k4 DMMA a fragment column and
// k step, which on an H100 issues at twice m8n8k4's rate with the same
// chain (tools/dmma_rate.py).  A lane reads its operands as single doubles
// and flips the sign bit where the product needs -pi or the conjugate, with
// no select.
//
// P and Q travel raw: complex K-slices of 8 (four k steps, a 128-byte row
// segment) go from device memory to shared memory by 16-byte cp.async, one
// complex value a copy, in a ring of kZ2Stages stages; while the block works
// on slice s the copies of the next kZ2Stages - 1 slices are in flight, and
// one barrier a slice both publishes slice s and frees the stage that the
// copies issued next will fill.  The conjugate's sign is taken where a lane
// reads its B operand (a negation is exact).  A row's eight values sit in
// its 128 bytes XOR-swizzled by 2 * (row % 4), so that the 8-byte reads of
// a half warp (four rows, 32 bytes each) fall on distinct banks.  Rows >= m
// (or n) and columns >= k are stored as zeros, which leaves an accumulator
// as it was.  The epilogue reads a row's values of B before it writes the
// first of OUT, so OUT may be B.  Shared memory: 4 stages of 16 KB, dynamic.
//
// Chosen by tools/kernel_variants.py --sweep-complex (NVIDIA H100 80GB
// HBM3, 700.00 W), rank-2k 8128^2 x 128: this form 1.81 ms of device time
// against torch.addmm's 1.89 ms and the 64-tile kernel's 2.75 ms.  128 x 64
// tiles (4 x 4 fragments a warp, 207 registers, one block an SM) took
// 2.14 ms; three blocks an SM (80 registers, spilling) 6.9 ms; B's tile
// staged into shared memory by cp.async under the DMMAs (a 64 KB share of
// its own) 1.97 ms against 1.83 ms without; 3 stages 1.81-1.83 ms, as 4.
// Without B's read the form takes 1.77 ms; without the imaginary
// accumulator's DMMAs (half of them) 1.30 ms, a saving of 0.50 ms, all the
// time those DMMAs take at m16n8k4's rate: the DMMAs run beside none of the
// operand reads and staging, which take the other 1.30 ms.
constexpr int kZ2TileM = 64;                     // complex output rows
constexpr int kZ2TileN = 64;                     // complex output columns
constexpr int kZ2Slice = 8;                      // complex K-slice: 4 k steps
constexpr int kZ2Stages = 4;                     // stages of the ring
constexpr int kZ2WarpsM = 4;                     // warps along the rows
constexpr int kZ2BlocksPerSm = 2;                // __launch_bounds__' minimum
constexpr long long kZ2TilesPerSm = 1;           // the c128 rule's factor
constexpr int kZ2WarpsN = kThreads / 32 / kZ2WarpsM;
constexpr int kZ2FragM = kZ2TileM / kZ2WarpsM / 8;
constexpr int kZ2FragN = kZ2TileN / kZ2WarpsN / 8;
constexpr int kZ2StageElems = (kZ2TileM + kZ2TileN) * kZ2Slice;
constexpr int kZ2Bytes = kZ2Stages * kZ2StageElems * 16;
static_assert(kZ2Slice == 8, "a 128-byte row segment, swizzled by row % 4");
static_assert(kZ2Stages >= 2, "a ring");
static_assert(kZ2FragM % 2 == 0, "16-row DMMA fragments");
static_assert(kZ2FragM * 8 * kZ2WarpsM == kZ2TileM &&
              kZ2FragN * 8 * kZ2WarpsN == kZ2TileN, "whole fragments");
static_assert((kZ2TileM * kZ2Slice) % kThreads == 0 &&
              (kZ2TileN * kZ2Slice) % kThreads == 0, "whole passes");

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr unsigned long long kSignBit = 1ull << 63;

// x with its sign bit flipped where `mask` has it: an exact negation, one
// integer operation on the high word
__device__ __forceinline__ double flip_sign(double x,
                                            unsigned long long mask) {
  return __longlong_as_double(__double_as_longlong(x) ^ mask);
}

// The place of complex value `c` (0..7) of row `r` in a ring stage's row.
__device__ __forceinline__ int ring_slot(int r, int c) {
  return c ^ ((r & 3) << 1);
}

// Starts the copies of an operand tile's slice [k0, k0 + 8) into `dst`
// (rows x 8 values, swizzled); zeros past `valid` rows and past k.
template <int kRows>
__device__ __forceinline__ void stage_slice(double2* dst,
                                            const double2* __restrict__ src,
                                            long long ld, int row0,
                                            int valid, int k0, int k) {
#pragma unroll
  for (int e = 0; e < kRows * kZ2Slice / kThreads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / kZ2Slice;
    const int c = idx % kZ2Slice;
    double2* d = dst + r * kZ2Slice + ring_slot(r, c);
    if (r < valid && k0 + c < k)
      cp_async16(d, src + static_cast<long long>(row0 + r) * ld + k0 + c);
    else
      *d = make_double2(0.0, 0.0);
  }
}

__global__ void __launch_bounds__(kThreads, kZ2BlocksPerSm)
sub_matmul_kernel_c128_ring(int m, int n, int k,
                            const double2* b, long long ldb,
                            const double2* __restrict__ p, long long ldp,
                            const double2* __restrict__ q, long long ldq,
                            double2* out, long long ldo) {
  // the ring: stage s holds P's slice (kZ2TileM rows of 8) and then Q's
  // (kZ2TileN rows)
  extern __shared__ __align__(16) unsigned char ring_smem[];
  double2* const ring = reinterpret_cast<double2*>(ring_smem);

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int g = lane / 4;          // fragment row of A and D, column of B
  const int tk = lane % 4;         // real k of a step; D's pair
  const int half = tk / 2;         // the complex k of the step it belongs to
  const bool odd = tk % 2 != 0;    // its imaginary part
  const int wr = (warp / kZ2WarpsN) * kZ2FragM * 8;  // the warp's rows
  const int wc = (warp % kZ2WarpsN) * kZ2FragN * 8;  // and columns
  const int row0 = blockIdx.y * kZ2TileM;
  const int col0 = blockIdx.x * kZ2TileN;
  const int rows = min(kZ2TileM, m - row0);   // valid rows of the tile
  const int cols = min(kZ2TileN, n - col0);   // and columns
  const int swz = (g & 3) << 1;    // ring_slot's XOR for this lane's rows
  // the double of a complex value this lane reads, and the sign bits it
  // flips: the real accumulator's A is -pi for odd t, B is conj(Q)'s -qi
  const int part = tk & 1;
  const unsigned long long neg_a = odd ? kSignBit : 0ull;
  const unsigned long long neg_c =
      __double_as_longlong(conj_part(1.0, odd)) & kSignBit;

  auto stage = [&](int s) {
    double2* st = ring + (s % kZ2Stages) * kZ2StageElems;
    stage_slice<kZ2TileM>(st, p, ldp, row0, rows, s * kZ2Slice, k);
    stage_slice<kZ2TileN>(st + kZ2TileM * kZ2Slice, q, ldq, col0, cols,
                          s * kZ2Slice, k);
  };
  const int slices = (k + kZ2Slice - 1) / kZ2Slice;

  // re[i][j], im[i][j] = D[g][2tk], D[g][2tk + 1] of fragment (i, j): rows
  // wr + 8i + g, columns wc + 8j + 2tk, + 1
  double re[kZ2FragM][kZ2FragN][2], im[kZ2FragM][kZ2FragN][2];
#pragma unroll
  for (int i = 0; i < kZ2FragM; ++i)
#pragma unroll
    for (int j = 0; j < kZ2FragN; ++j)
      re[i][j][0] = re[i][j][1] = im[i][j][0] = im[i][j][1] = 0.0;

  // one group a slice, empty past the last, so that the wait below always
  // leaves the newest kZ2Stages - 2 in flight
#pragma unroll
  for (int s = 0; s < kZ2Stages - 1; ++s) {
    if (s < slices) stage(s);
    cp_async_commit();
  }

  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kZ2Stages - 2>();
    __syncthreads();
    // the stage of slice s + kZ2Stages - 1 was read in step s - 1, which
    // every thread has left
    if (s + kZ2Stages - 1 < slices) stage(s + kZ2Stages - 1);
    cp_async_commit();

    const double2* sp = ring + (s % kZ2Stages) * kZ2StageElems;
    const double2* sq = sp + kZ2TileM * kZ2Slice;
    // the slice's four k steps in ascending order
#pragma unroll
    for (int h = 0; h < kZ2Slice / 2; ++h) {
      // the doubles of complex k 2h + half in this lane's rows
      const int e = 2 * ((2 * h + half) ^ swz);
      double ar[kZ2FragM], ai[kZ2FragM], c[kZ2FragN];
#pragma unroll
      for (int i = 0; i < kZ2FragM; ++i) {
        const double* row =
            reinterpret_cast<const double*>(sp + (wr + i * 8 + g) * kZ2Slice);
        ar[i] = flip_sign(row[e + part], neg_a);   // pr, or -pi
        ai[i] = row[e + (part ^ 1)];               // pi, or pr
      }
#pragma unroll
      for (int j = 0; j < kZ2FragN; ++j) {
        const double* row =
            reinterpret_cast<const double*>(sq + (wc + j * 8 + g) * kZ2Slice);
        c[j] = flip_sign(row[e + part], neg_c);    // cr, or ci = -qi
      }
      // fragments 2u and 2u + 1 (rows 16u + g and 16u + 8 + g) in one
      // 16 x 8 x 4 product
#pragma unroll
      for (int u = 0; u < kZ2FragM; u += 2)
#pragma unroll
        for (int j = 0; j < kZ2FragN; ++j)
          dmma_m16n8k4(re[u][j], re[u + 1][j], ar[u], ar[u + 1], c[j]);
#pragma unroll
      for (int u = 0; u < kZ2FragM; u += 2)
#pragma unroll
        for (int j = 0; j < kZ2FragN; ++j)
          dmma_m16n8k4(im[u][j], im[u + 1][j], ai[u], ai[u + 1], c[j]);
    }
  }

  // a row's values of B are read before the first is written: OUT may be B
#pragma unroll
  for (int i = 0; i < kZ2FragM; ++i) {
    const int r = wr + i * 8 + g;
    if (r >= rows) continue;
    const double2* src = b + static_cast<long long>(row0 + r) * ldb + col0;
    double2* dst = out + static_cast<long long>(row0 + r) * ldo + col0;
    double2 bv[kZ2FragN][2];
#pragma unroll
    for (int j = 0; j < kZ2FragN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wc + j * 8 + 2 * tk + e;
        if (c < cols)
          bv[j][e] = src[c];
      }
#pragma unroll
    for (int j = 0; j < kZ2FragN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wc + j * 8 + 2 * tk + e;
        if (c < cols)
          dst[c] = make_double2(bv[j][e].x - re[i][j][e],
                                bv[j][e].y - im[i][j][e]);
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

// Whether a launch has at least `factor` tiles of tile_m x tile_n for each
// SM (never where the SM count is unknown).
bool fills_sms(int m, int n, int tile_m, int tile_n, long long factor) {
  const int sms = sm_count();
  const long long tiles = static_cast<long long>((m + tile_m - 1) / tile_m) *
                          ((n + tile_n - 1) / tile_n);
  return sms > 0 && tiles >= factor * sms;
}

int launch(int m, int n, int k, const float* b, long long ldb, const float* p,
           long long ldp, const float* q, long long ldq, float* out,
           long long ldo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fills_sms(m, n, kBigTile, kBigTile, kBigTilesPerSm)) {
    const dim3 big((n + kBigTile - 1) / kBigTile,
                   (m + kBigTile - 1) / kBigTile);
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

// c64: the 64 x 128-tile kernel where the 64-tile kernel would have at
// least one tile for each SM, the 64-tile kernel below that (the late, small
// trailing updates of a reduction), where it runs in one wave and is the
// faster (tools/kernel_variants.py --sweep-complex: at m = 704, 121 tiles,
// 0.0264 ms against 0.0305; at m = 768, 144 tiles, 0.0355 against 0.0307;
// graph time, NVIDIA H100 80GB HBM3, 700.00 W).  Both give the same bits.
int launch(int m, int n, int k, const float2* b, long long ldb,
           const float2* p, long long ldp, const float2* q, long long ldq,
           float2* out, long long ldo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fills_sms(m, n, kCTile, kCTile, kC2TilesPerSm)) {
    const dim3 grid((n + kC2TileN - 1) / kC2TileN,
                    (m + kC2TileM - 1) / kC2TileM);
    sub_matmul_kernel_c64_wide<<<grid, kThreads, 0, s>>>(
        m, n, k, b, ldb, p, ldp, q, ldq, out, ldo);
  } else {
    const dim3 grid((n + kCTile - 1) / kCTile, (m + kCTile - 1) / kCTile);
    sub_matmul_kernel_c64<<<grid, kThreads, 0, s>>>(
        m, n, k, b, ldb, p, ldp, q, ldq, out, ldo);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// The ring kernel's dynamic shared memory, allowed once a device.
cudaError_t allow_ring_smem() {
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(sub_matmul_kernel_c128_ring,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kZ2Bytes);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

// c128: the ring kernel where its tiles (64 x 64, as the other's) give each SM
// at least one and the operands are 16-byte aligned (cp.async's copies; a
// c128 tensor always is), the 64-tile kernel otherwise.  Both give the same
// bits.  The sweep (tools/kernel_variants.py --sweep-complex, NVIDIA H100
// 80GB HBM3, 700.00 W) has the ring faster at every size, also in one wave
// (m = 704: 0.0200 ms of graph time against 0.0325); the 64-tile kernel keeps
// the launches under one tile an SM all the same, where a call costs the
// host's launch interval (0.03-0.05 ms) whichever kernel runs, so that
// every run of chip_smoke.py holds the ring to its bits on the card.
int launch(int m, int n, int k, const double2* b, long long ldb,
           const double2* p, long long ldp, const double2* q, long long ldq,
           double2* out, long long ldo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(b) && aligned16(p) && aligned16(q);
  if (aligned && fills_sms(m, n, kZ2TileM, kZ2TileN, kZ2TilesPerSm)) {
    const cudaError_t err = allow_ring_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kZ2TileN - 1) / kZ2TileN,
                    (m + kZ2TileM - 1) / kZ2TileM);
    sub_matmul_kernel_c128_ring<<<grid, kThreads, kZ2Bytes, s>>>(
        m, n, k, b, ldb, p, ldp, q, ldq, out, ldo);
  } else {
    const dim3 grid((n + kZTile - 1) / kZTile, (m + kZTile - 1) / kZTile);
    sub_matmul_kernel_c128<<<grid, kThreads, 0, s>>>(
        m, n, k, b, ldb, p, ldp, q, ldq, out, ldo);
  }
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

// Complex entry points: OUT = B - P * Q^H on interleaved (re, im) storage,
// leading dimensions in complex elements.
extern "C" int eigenexa_sub_matmul_c64(int m, int n, int k, const float2* b,
                                       long long ldb, const float2* p,
                                       long long ldp, const float2* q,
                                       long long ldq, float2* out,
                                       long long ldo, void* stream) {
  return launch(m, n, k, b, ldb, p, ldp, q, ldq, out, ldo, stream);
}

extern "C" int eigenexa_sub_matmul_c128(int m, int n, int k, const double2* b,
                                        long long ldb, const double2* p,
                                        long long ldp, const double2* q,
                                        long long ldq, double2* out,
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
