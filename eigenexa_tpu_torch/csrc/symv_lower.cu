// Q = B * X for symmetric B, reading only the lower triangle of the window
// B[w:, w:]; rows of Q above the window come back zero.  With a panel
// (one vector only) the summing pass also applies the Householder panel's
// corrections:  q = S x - U (W^T x) - W (U^T x)  on the window's rows.
//
// Replaces the Pallas TPU kernel `_symv_pallas` (public `symv_lower`, grid
// decode `_symv_decode`) of eigenexa_tpu/ops/pallas_kernels.py: the panel
// matvec of the windowed Householder reduction, called once per column
// (reference: the distributed symv of src/eigen_trd_t2.F:161; nc = 2 is the
// two-vector PDSYMV2 pass of src/eigen_prd_t2.F:90).  On the TPU the
// corrections were separate products after the kernel
// (eigenexa_tpu/ops/householder.py `_panel_win`).
//
// What bounds it on an H100: bytes.  Every element of the window's lower
// triangle is read once and used for two multiply-adds per vector, far
// below the ~20 flop/B where 67 TFLOP/s of FP32 meets 3.35 TB/s of HBM.  The
// least time is (m - w)^2 / 2 elements over the memory rate: 537 MB, 0.16 ms
// for the first column of n = 16384 in f32, against 1.07 GB for a matvec
// over the full square.  So what the design buys is bytes kept in flight.
//
// Blocks run in no order and the q_i / q_j contributions of a tile land in
// two different row blocks.  Atomics would make the sum's order change from
// run to run, which the solver's bitwise-repeat contract forbids.  So the
// product is two passes:
//   * pass 1, `symv_partial_kernel`: a persistent grid (as many blocks as
//     fit on the card at once, never more than there are tiles) walks the
//     window's lower tiles of kTile rows by kTileCols columns in row-major
//     order, block b taking tiles b, b + grid, b + 2 grid, ...  Each block
//     streams its tiles, with their x segments, through a ring of kStages
//     stages in shared memory with cp.async: while it reduces tile k, the
//     copies of the next kStages - 1 tiles are in flight.  16-byte
//     cp.async.cg copies where the view is 16-byte aligned, 4- or 8-byte
//     element copies where it is not (odd strides, offset views) or where a
//     row ends inside a chunk; elements past the edge are zero-filled.  A
//     tile is 64 x 128 (kTileCols): its row segments are 512 (f32) or 1024
//     (f64) contiguous bytes, half the tiles and a quarter fewer slots than
//     64 x 64.  A tile is read out of shared memory as 16-byte vectors, a
//     quarter warp on 128 contiguous bytes (no bank conflict), 4 rows a
//     thread.  From
//     those registers the block forms A_ij * x_j (a shuffle sum over the 16
//     threads that share a row, 5 shuffles for a thread's 4 rows) and, for
//     the same elements, A_ij^T * x_i (a sum over the thread's rows, a
//     shuffle for every two columns, then over the 8 warps through shared
//     memory), for all vectors.  Only elements on or below the
//     diagonal count; the diagonal itself only once.  Each partial goes to
//     its own slot: R[tj][vector][row] for the row part of tile (ti, tj),
//     C[ti][vector][col] for its column part, so every slot is written
//     exactly once and none is added to across blocks;
//   * pass 2, `symv_sum_kernel`, sums the slots of each row in a fixed
//     order (R ascending, then C ascending, split over 8 interleaved
//     groups that are added in order), subtracts the panel's corrections
//     (U (W^T x) and then W (U^T x), each a dot over the row's panel entries
//     with g = [U^T x ; W^T x], which the caller computed; a warp a row, its
//     lanes on neighbouring panel columns), writes q, and writes zeros above
//     the window.  Fusing them saves the column four matvecs over the
//     window and two passes over q.
// A tile's partials do not depend on which block took it, so the bits do not
// depend on the grid either.  The scratch adds about 2 * (m - w)^2 *
// (1/64 + 1/kTileCols) / 2 elements of traffic: 2.3% of the triangle at
// 64 x 128 tiles, 3.1% at 64 x 64.  Both shapes were timed on an H100
// (tools/kernel_variants.py --source symv_lower.cu, PERF.md); 64 x 128 was
// as fast or faster.  The window start w is the caller's; tiles are this
// kernel's own.
//
// The first design, for history: one short-lived block per 64 x 64 tile,
// the tile loaded straight into registers before a barrier, the panel's
// corrections as four separate products after the call.  It already kept
// enough bytes in flight through the other resident blocks: 0.198 ms for the
// first f32 column of n = 16384 (2.7 TB/s; tools/old_new.py on an H100,
// PERF.md), and this design times within a few percent of it, a little
// behind, on windows of 8192 rows and more.
//
// Later work, not here: TMA cannot take the odd strides this kernel must
// take; one cooperative launch with a grid barrier could replace pass 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                          // tile rows (height)
constexpr int kTileCols = 128;                     // tile columns: 64 or 128
constexpr int kStages = 3;                         // depth of the copy ring
constexpr int kThreads = 256;
constexpr int kColGroups = 16;                     // threads along a tile row
constexpr int kRowGroups = kThreads / kColGroups;  // threads down a column
constexpr int kRowsPerThread = kTile / kRowGroups;
constexpr int kColsPerThread = kTileCols / kColGroups;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 232448;        // what a block may use
constexpr int kMaxDevices = 64;

constexpr int kSumRows = 32;     // pass 2: rows per block
constexpr int kSumGroups = 8;    // pass 2: interleaved groups of slots

static_assert(kTileCols == kTile || kTileCols == 2 * kTile,
              "tiles_before knows square tiles and tiles twice as wide");

// Shared memory of pass 1: kStages stages of {tile, x at its columns, x at
// its rows} (two where three do not fit), then the row sums and the per-warp
// column sums of one tile.
template <typename T, int NC>
struct Layout {
  static constexpr int kStageElems = kTile * kTileCols + NC * (kTileCols + kTile);
  static constexpr int kSums = NC * kTile + kWarps * NC * kTileCols;
  static constexpr int kStagesUsed =
      (kStages * kStageElems + kSums) * sizeof(T) <= kMaxSharedBytes ? kStages : 2;
  static constexpr size_t kBytes = (kStagesUsed * kStageElems + kSums) * sizeof(T);
  static_assert(kBytes <= kMaxSharedBytes, "pass 1 does not fit an SM");
};

// Tile row ti holds the lower tiles tj = 0 .. last_col(ti).
__host__ __device__ inline int last_col(int ti) {
  return (kTile * ti + kTile - 1) / kTileCols;
}

// Lower tiles before tile row ti.
inline long long tiles_before(int ti) {
  if (kTileCols == kTile) return static_cast<long long>(ti) * (ti + 1) / 2;
  const long long a = ti / 2;
  return ti % 2 == 0 ? a * (a + 1) : (a + 1) * (a + 1);
}

// A block's walk over the lower tiles in row-major order: from tile `t`,
// `step` tiles at a time.
struct TileWalk {
  int ti = 0, tj = 0;
  __device__ explicit TileWalk(int t) { advance(t); }
  __device__ void advance(int step) {
    tj += step;
    while (tj > last_col(ti)) {
      tj -= last_col(ti) + 1;
      ++ti;
    }
  }
};

// Column e of a thread's kColsPerThread, for column group cg: 16-byte
// vectors, the vectors of one thread kColGroups vectors apart, so that a
// quarter warp reads 128 contiguous bytes of a tile row.
template <typename T>
__device__ inline int col_of(int cg, int e) {
  constexpr int kVec = 16 / sizeof(T);
  return (e / kVec) * (kColGroups * kVec) + kVec * cg + e % kVec;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::
               "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
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

__device__ __forceinline__ void copy_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}

__device__ __forceinline__ void copy_elem(double* dst, const double* src) {
  cp_async8(dst, src);
}

// Starts the copies of tile (ti, tj) and its x segments into stage `st`.
// A thread copies the 16-byte chunks kChunkRows rows apart from its own:
// chunk column `cc`, first row `cr`.
template <typename T, int NC>
__device__ void load_tile(T* st, int ti, int tj, int mw, int nc, bool aligned,
                          const T* a, long long lda, const T* x,
                          long long ldx) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kTileCols / kVec;        // 16-byte chunks a row
  constexpr int kChunkRows = kThreads / kChunks;   // rows a pass covers
  const int cr = threadIdx.x / kChunks;
  const int cc = (threadIdx.x % kChunks) * kVec;
  const int row0 = ti * kTile;
  const int col0 = tj * kTileCols;
  T* dst = st + cr * kTileCols + cc;
  const T* src = a + static_cast<long long>(row0 + cr) * lda + col0 + cc;
  if (aligned && row0 + kTile <= mw && col0 + kTileCols <= mw) {
#pragma unroll
    for (int p = 0; p < kTile / kChunkRows; ++p)
      cp_async16(dst + p * kChunkRows * kTileCols, src + p * kChunkRows * lda);
  } else {
    const int gc = col0 + cc;
    for (int p = 0; p < kTile / kChunkRows; ++p) {
      const int gr = row0 + cr + p * kChunkRows;
      T* d = dst + p * kChunkRows * kTileCols;
      const T* g = src + p * kChunkRows * lda;
      if (gr < mw && aligned && gc + kVec <= mw) {
        cp_async16(d, g);
      } else {
        for (int e = 0; e < kVec; ++e) {
          if (gr < mw && gc + e < mw) copy_elem(d + e, g + e);
          else d[e] = T(0);
        }
      }
    }
  }
  T* xc = st + kTile * kTileCols;
  T* xr = xc + NC * kTileCols;
  for (int e = threadIdx.x; e < NC * (kTileCols + kTile); e += kThreads) {
    int c, g;
    T* d;
    if (e < NC * kTileCols) {
      c = e / kTileCols;
      g = col0 + e % kTileCols;
      d = xc + e;
    } else {
      const int f = e - NC * kTileCols;
      c = f / kTile;
      g = row0 + f % kTile;
      d = xr + f;
    }
    if (c < nc && g < mw) copy_elem(d, x + static_cast<long long>(g) * ldx + c);
    else *d = T(0);
  }
}

__device__ inline void load_vec(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ inline void load_vec(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}

static_assert(kRowsPerThread == 4, "row_sums takes four rows a thread");

// The four row partials v of each thread, summed over the 16 threads of a
// half warp that share those rows, in 5 shuffles instead of 16: at each of
// the first two steps a thread keeps half of its rows and sends the other
// half to its partner.  Lanes with cg % 4 == 0 return the sum of their row
// 2 * bit3(cg) + bit2(cg); a + b = b + a, so both partners of a step hold
// the same bits.
template <typename T>
__device__ inline T row_sums(const T (&v)[4], int cg) {
  const bool hi8 = cg & 8;
  T keep0 = hi8 ? v[2] : v[0];
  T keep1 = hi8 ? v[3] : v[1];
  keep0 += __shfl_xor_sync(kFullMask, hi8 ? v[0] : v[2], 8);
  keep1 += __shfl_xor_sync(kFullMask, hi8 ? v[1] : v[3], 8);
  const bool hi4 = cg & 4;
  T keep = hi4 ? keep1 : keep0;
  keep += __shfl_xor_sync(kFullMask, hi4 ? keep0 : keep1, 4);
  keep += __shfl_xor_sync(kFullMask, keep, 2);
  keep += __shfl_xor_sync(kFullMask, keep, 1);
  return keep;
}

// A tile's slots from its sums in shared memory: the column sums over the
// 8 warps in order, and the row sums.
template <typename T, int NC>
__device__ void write_slots(const T* rowres, int ti, int tj, int mw, int nc,
                            T* __restrict__ rslot, T* __restrict__ cslot) {
  const T* colred = rowres + NC * kTile;
  const int row0 = ti * kTile;
  const int col0 = tj * kTileCols;
  for (int e = threadIdx.x; e < NC * kTileCols; e += kThreads) {
    const int c = e / kTileCols;
    const int col = e % kTileCols;
    if (c >= nc || col0 + col >= mw) continue;
    T cs = T(0);
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) cs += colred[(wp * NC + c) * kTileCols + col];
    cslot[(static_cast<long long>(ti) * nc + c) * mw + col0 + col] = cs;
  }
  for (int e = threadIdx.x; e < NC * kTile; e += kThreads) {
    const int c = e / kTile;
    const int r = e % kTile;
    if (c >= nc || row0 + r >= mw) continue;
    rslot[(static_cast<long long>(tj) * nc + c) * mw + row0 + r] = rowres[c * kTile + r];
  }
}

// a, x: at the window's origin (row and column w of B, row w of X).
// rslot: R[tj][c][row], cslot: C[ti][c][col], each (m - w) rows long.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
symv_partial_kernel(int mw, int nc, int ntiles, bool aligned,
                    const T* __restrict__ a, long long lda,
                    const T* __restrict__ x, long long ldx,
                    T* __restrict__ rslot, T* __restrict__ cslot) {
  using L = Layout<T, NC>;
  constexpr int kS = L::kStagesUsed;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHalfCols = kColsPerThread / 2;
  extern __shared__ __align__(16) unsigned char symv_smem[];
  T* const ring = reinterpret_cast<T*>(symv_smem);
  T* const rowres = ring + kS * L::kStageElems;     // [NC][kTile]
  T* const colred = rowres + NC * kTile;            // [kWarps][NC][kTileCols]

  const int cg = threadIdx.x % kColGroups;
  const int rg = threadIdx.x / kColGroups;
  const int warp = threadIdx.x / 32;
  const bool upper = threadIdx.x % 32 >= 16;        // the warp's second row group
  const int step = gridDim.x;
  const int count = blockIdx.x < ntiles ? (ntiles - blockIdx.x + step - 1) / step : 0;
  if (count == 0) return;
  TileWalk issue(blockIdx.x), tile(blockIdx.x);

  // the ring's prologue: one commit a stage, empty where there is no tile,
  // so that every thread counts the same groups
  for (int s = 0; s < kS - 1; ++s) {
    if (s < count) {
      load_tile<T, NC>(ring + s * L::kStageElems, issue.ti, issue.tj, mw, nc,
                       aligned, a, lda, x, ldx);
      issue.advance(step);
    }
    cp_async_commit();
  }

  for (int k = 0; k < count; ++k) {
    // this thread's copies of tile k have landed; the barrier makes every
    // thread's visible and ends all use of the stage that is refilled next
    // and of the sums of tile k - 1
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (k + kS - 1 < count) {
      load_tile<T, NC>(ring + ((k + kS - 1) % kS) * L::kStageElems, issue.ti,
                       issue.tj, mw, nc, aligned, a, lda, x, ldx);
      issue.advance(step);
    }
    cp_async_commit();

    const int ti = tile.ti;
    const int tj = tile.tj;
    tile.advance(step);
    const int row0 = ti * kTile;
    const int col0 = tj * kTileCols;
    const T* st = ring + (k % kS) * L::kStageElems;
    const T* xc = st + kTile * kTileCols;
    const T* xr = xc + NC * kTileCols;
    // the tile reaches above the diagonal: only col <= row counts
    const bool edge = col0 + kTileCols - 1 > row0;

    T av[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + kRowGroups * i;
#pragma unroll
      for (int e = 0; e < kColsPerThread; e += kVec)
        load_vec(st + r * kTileCols + col_of<T>(cg, e), &av[i][e]);
      if (edge) {
#pragma unroll
        for (int e = 0; e < kColsPerThread; ++e)
          if (col0 + col_of<T>(cg, e) > row0 + r) av[i][e] = T(0);
      }
    }

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      // A_ij * x_j: a row's 64 products over the 16 threads that share it
      T xcv[kColsPerThread];
#pragma unroll
      for (int e = 0; e < kColsPerThread; ++e)
        xcv[e] = xc[c * kTileCols + col_of<T>(cg, e)];
      T rs[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        T s = T(0);
#pragma unroll
        for (int e = 0; e < kColsPerThread; ++e) s = fma(av[i][e], xcv[e], s);
        rs[i] = s;
      }
      const T rsum = row_sums(rs, cg);
      if (cg % 4 == 0)
        rowres[c * kTile + rg + kRowGroups * (2 * ((cg >> 3) & 1) + ((cg >> 2) & 1))] = rsum;

      // A_ij^T * x_i: a column's products over the thread's rows, then over
      // the warp's two row groups (each lane keeps half of its columns),
      // then over the 8 warps in the epilogue.  The diagonal itself
      // already counted above.
      T cs[kColsPerThread];
#pragma unroll
      for (int e = 0; e < kColsPerThread; ++e) {
        const int col = col0 + col_of<T>(cg, e);
        T s = T(0);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = rg + kRowGroups * i;
          const T aa = (edge && col == row0 + r) ? T(0) : av[i][e];
          s = fma(aa, xr[c * kTile + r], s);
        }
        cs[e] = s;
      }
#pragma unroll
      for (int h = 0; h < kHalfCols; ++h) {
        T keep = upper ? cs[h + kHalfCols] : cs[h];
        keep += __shfl_xor_sync(kFullMask, upper ? cs[h] : cs[h + kHalfCols], 16);
        colred[(warp * NC + c) * kTileCols + col_of<T>(cg, upper ? h + kHalfCols : h)] = keep;
      }
    }
    __syncthreads();
    write_slots<T, NC>(rowres, ti, tj, mw, nc, rslot, cslot);
  }
}

// q[row, c] = the row's slots summed in a fixed order, minus the panel's
// corrections; 0 above the window.  panel: (m, 2 * half) row-major, U in
// columns [0, nb), W in [half, half + nb); g = [U^T x ; W^T x], 2 * half long.
// The slots are read a row a thread (32 rows, 8 interleaved groups of
// slots); the panel a row a warp, its lanes on neighbouring columns, each
// warp 4 rows.  A warp's panel and g entries of the first 64 columns are
// loaded before the slot sums, so that their latency hides under them.
template <typename T>
__global__ void __launch_bounds__(kSumRows * kSumGroups)
symv_sum_kernel(int m, int w, int nc, int n_row_tiles,
                const T* __restrict__ rslot, const T* __restrict__ cslot,
                const T* __restrict__ panel, long long ldp, int half, int nb,
                const T* __restrict__ g, T* __restrict__ q, long long ldq) {
  constexpr int kPanelRows = kSumRows / kSumGroups;   // a warp's panel rows
  __shared__ T red[kSumGroups][kSumRows];
  __shared__ T corr[2][kSumRows];
  const int tx = threadIdx.x % kSumRows;
  const int ty = threadIdx.x / kSumRows;
  const int row = blockIdx.x * kSumRows + tx;
  const int c = blockIdx.y;
  const long long mw = m - w;

  // U[prow, l], W[prow, l] and g at l = tx and tx + 32, zero outside
  T pu[kPanelRows][2], pw[kPanelRows][2], gw[2], gu[2];
  if (panel != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = tx + 32 * h;
      gw[h] = l < nb ? g[half + l] : T(0);
      gu[h] = l < nb ? g[l] : T(0);
#pragma unroll
      for (int k = 0; k < kPanelRows; ++k) {
        const int prow = blockIdx.x * kSumRows + ty + kSumGroups * k;
        const bool in = l < nb && prow >= w && prow < m;
        const T* p = panel + static_cast<long long>(prow) * ldp;
        pu[k][h] = in ? p[l] : T(0);
        pw[k][h] = in ? p[half + l] : T(0);
      }
    }
  }

  T s = T(0);
  if (row >= w && row < m) {
    const int r = row - w;
    const int nr = last_col(r / kTile) + 1;              // R[0 .. nr)
    const int lo = (r / kTileCols) * kTileCols / kTile;  // C[lo .. n_row_tiles)
    const int ns = nr + n_row_tiles - lo;
    for (int t = ty; t < ns; t += kSumGroups)
      s += t < nr ? rslot[(static_cast<long long>(t) * nc + c) * mw + r]
                  : cslot[(static_cast<long long>(lo + t - nr) * nc + c) * mw + r];
  }
  red[ty][tx] = s;

  if (panel != nullptr) {
    // U (W^T x) and W (U^T x) of the warp's rows: lane partials over
    // columns tx, tx + 32, tx + 64, ..., then a tree over the lanes
#pragma unroll
    for (int k = 0; k < kPanelRows; ++k) {
      const int rr = ty + kSumGroups * k;
      const int prow = blockIdx.x * kSumRows + rr;
      T cu = fma(pu[k][1], gw[1], pu[k][0] * gw[0]);
      T cw = fma(pw[k][1], gu[1], pw[k][0] * gu[0]);
      if (prow >= w && prow < m) {
        const T* p = panel + static_cast<long long>(prow) * ldp;
        for (int l = tx + 64; l < nb; l += 32) {
          cu = fma(p[l], g[half + l], cu);
          cw = fma(p[half + l], g[l], cw);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cu += __shfl_xor_sync(kFullMask, cu, off);
        cw += __shfl_xor_sync(kFullMask, cw, off);
      }
      if (tx == 0) {
        corr[0][rr] = cu;
        corr[1][rr] = cw;
      }
    }
  }
  __syncthreads();
  if (ty == 0 && row < m) {
    T total = T(0);
#pragma unroll
    for (int k = 0; k < kSumGroups; ++k) total += red[k][tx];
    if (panel != nullptr) total = (total - corr[0][tx]) - corr[1][tx];
    q[row * ldq + c] = row < w ? T(0) : total;
  }
}

// Blocks of pass 1 that fit on one SM, read once a device: the shared-memory
// attribute is set then too.
template <typename T, int NC>
cudaError_t blocks_per_sm(int device, int* out) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    using L = Layout<T, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        symv_partial_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, symv_partial_kernel<T, NC>, kThreads, L::kBytes);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cached[device] = n;
  }
  *out = cached[device];
  return cudaSuccess;
}

// SMs of the device, read once a device.
cudaError_t sm_count(int device, int* out) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &cached[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *out = cached[device];
  return cudaSuccess;
}

template <typename T, int NC>
cudaError_t launch_partial(int mw, int nc, int ntiles, bool aligned,
                           const T* a, long long lda, const T* x,
                           long long ldx, T* rslot, T* cslot,
                           cudaStream_t stream) {
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = blocks_per_sm<T, NC>(device, &per_sm);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  symv_partial_kernel<T, NC><<<grid, kThreads, Layout<T, NC>::kBytes, stream>>>(
      mw, nc, ntiles, aligned, a, lda, x, ldx, rslot, cslot);
  return cudaGetLastError();
}

template <typename T>
int launch(int m, int w, int nc, const T* b, long long ldb, const T* x,
           long long ldx, T* q, long long ldq, T* scratch,
           long long scratch_len, const T* panel, long long ldp, int half,
           int nb, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (w < 0 || w >= m || nc < 1 || nc > 8) return cudaErrorInvalidValue;
  if (panel != nullptr && (nc != 1 || nb < 0 || nb > half))
    return cudaErrorInvalidValue;
  const int mw = m - w;
  const int n_row_tiles = (mw + kTile - 1) / kTile;
  const int n_col_tiles = (mw + kTileCols - 1) / kTileCols;
  const long long g_len = panel != nullptr ? 2LL * half : 0;
  const long long r_len = static_cast<long long>(n_col_tiles) * nc * mw;
  const long long c_len = static_cast<long long>(n_row_tiles) * nc * mw;
  if (g_len + r_len + c_len > scratch_len) return cudaErrorInvalidValue;
  const T* g = scratch;
  T* rslot = scratch + g_len;
  T* cslot = rslot + r_len;
  const int ntiles = static_cast<int>(tiles_before(n_row_tiles));
  const T* a = b + w * ldb + w;
  const T* xw = x + w * ldx;
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      ldb % kVec == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  cudaError_t err;
  if (nc == 1) {
    err = launch_partial<T, 1>(mw, nc, ntiles, aligned, a, ldb, xw, ldx,
                               rslot, cslot, stream);
  } else if (nc == 2) {
    err = launch_partial<T, 2>(mw, nc, ntiles, aligned, a, ldb, xw, ldx,
                               rslot, cslot, stream);
  } else if (nc <= 4) {
    err = launch_partial<T, 4>(mw, nc, ntiles, aligned, a, ldb, xw, ldx,
                               rslot, cslot, stream);
  } else {
    err = launch_partial<T, 8>(mw, nc, ntiles, aligned, a, ldb, xw, ldx,
                               rslot, cslot, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kSumRows - 1) / kSumRows, nc);
  symv_sum_kernel<T><<<grid, kSumRows * kSumGroups, 0, stream>>>(
      m, w, nc, n_row_tiles, rslot, cslot, panel, ldp, half, nb, g, q, ldq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  B is (m, m) with leading dimension ldb;
// X is (m, nc) with row stride ldx and unit column stride; Q is (m, nc) with
// row stride ldq.  scratch holds scratch_len elements: first, where there is
// a panel, g = [U^T x ; W^T x] (2 * half elements, written by the caller),
// then the slots, ceil((m - w) / kTileCols) + ceil((m - w) / 64) times
// nc * (m - w) elements, so 2 * ceil((m - w) / 64) * nc * (m - w) is enough
// for any tile width.  panel is null or (m, 2 * half) with leading dimension
// ldp, U in its columns [0, nb) and W in [half, half + nb); it takes nc = 1.
// They launch both passes on `stream`, which must belong to the current
// device, do not synchronize, allocate nothing, and return the first error
// that is not cudaSuccess (cudaErrorInvalidValue for arguments they refuse).
extern "C" int eigenexa_symv_lower_f32(int m, int w, int nc, const float* b,
                                       long long ldb, const float* x,
                                       long long ldx, float* q, long long ldq,
                                       float* scratch, long long scratch_len,
                                       const float* panel, long long ldp,
                                       int half, int nb, void* stream) {
  return launch<float>(m, w, nc, b, ldb, x, ldx, q, ldq, scratch, scratch_len,
                       panel, ldp, half, nb, stream);
}

extern "C" int eigenexa_symv_lower_f64(int m, int w, int nc, const double* b,
                                       long long ldb, const double* x,
                                       long long ldx, double* q,
                                       long long ldq, double* scratch,
                                       long long scratch_len,
                                       const double* panel, long long ldp,
                                       int half, int nb, void* stream) {
  return launch<double>(m, w, nc, b, ldb, x, ldx, q, ldq, scratch,
                        scratch_len, panel, ldp, half, nb, stream);
}
