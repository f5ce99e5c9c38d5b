// Index-targeted Sturm bisection of a symmetric tridiagonal (band 1) or
// pentadiagonal (band 2) matrix: for every eigenvalue index i, n_iter
// halvings of a bracket [a_i, b_i] that keeps count(a_i) <= i < count(b_i),
// count(x) being the number of eigenvalues below x by the Sturm recurrence.
//
// Not a TPU kernel: the JAX package runs this as a `lax.scan` over the
// matrix dimension inside `lax.fori_loop`s of bisection steps
// (eigenexa_tpu/ops/sturm.py: `sturm_count` :29 and `eigvals_bisect` :66,
// `sturm_count_band2` :96 and `eigvals_bisect_band2` :162, the refinements
// `refine_eigenvalues_band2` :187 and `refine_eigenvalues` :219), which XLA
// compiles into one program.  Eager PyTorch on the card would issue some
// 4 ops x n steps x n_iter launches (2.3 M at n = 8192 in band 1), so the
// card form of those loops is this one kernel (reference: eigen_bisect,
// src/bisect.F:67, and eigen_bisect2, src/bisect2.F:71).
//
// Design: multisection by lane groups.  A group of G = 2^L lanes of one
// warp owns one eigenvalue index i and keeps its bracket [a, b] in
// registers, the same bracket in every lane.  One round does L bisection
// steps at once.  Number the nodes of the next L levels of the bisection
// tree as a heap, 1 ... 2^L - 1: lane k walks down from [a, b] to node k by
// the midpoint expression of one step, 0.5 (lo + hi), and runs the whole
// Sturm recurrence at that probe; `__ballot_sync` gives every lane of the
// group the bits count > i of all its probes; every lane then walks the
// heap from node 1 with those bits and updates [a, b] by the same midpoint
// expressions.  The bracket after a round is thus the bracket after L steps
// of bisection, bit for bit, for one chain of n dependent steps where
// bisection takes L.  The last round takes the n_iter mod L levels that
// are left.  Lane 0 of a group probes no node; in the refinement's valid
// check lanes 0 and 1 count at a0 and b0 in one call.
//
// The band entries are read by every lane in lockstep: a block stages them
// through shared memory kChunk at a time and reads them as broadcasts.
// Every thread of a block makes the same number of counts (one a round, one
// for the valid check, n_iter being uniform), so the barriers of the
// staging loop meet.  A block of kThreads lanes holds kThreads / G indices,
// so the n G threads spread over the whole card (at n = 8192 and L = 3,
// 512 blocks of 128 for 132 SMs).
//
// The bits: every operation is the JAX scan's operation with one rounding
// (the _rn intrinsics are never contracted into an fma), in the scan's
// order, so the kernel equals its plain PyTorch version
// (ops/kernels.py `_sturm_bisect_ref`) bit for bit:
//   band 1   q = (d_k - x) - e_k^2 / q,  q <- -pivmin where |q| < pivmin
//   band 2   piv = a (+-pivmin where |a| < pivmin), l1 = b / piv,
//            l2 = e2_k / piv, a' = c - l1 b, b' = e1_{k+1} - l1 e2_k,
//            c' = (d_{k+2} - x) - l2 e2_k
// and count(x) is the number of negative q (piv).  The pivmin clamps,
// 1e-30 max(e^2, 1) and 1e-28 (max(|d|, 1) + max|e1| + max|e2|), keep the
// counts integer-exact where a pivot meets zero; the caller computes them.
//
// What bounds it on an H100: the latency of the recurrence.  A step waits
// for the previous step's division (a Newton sequence of dependent FP64
// instructions), and the recurrence has no parallel axis of its own that
// keeps the bits.  One thread an index would run, at n = 8192, one chain of
// 70 x 8192 steps a scheduler on 64 of the 132 SMs: 47 ms for band 1
// against 0.69 ms of operations (PERF.md).  Multisection trades
// work for latency: a round does (2^L - 1) / L times bisection's counts
// (2^L lanes run) in exchange for L times fewer dependent steps, and G
// times as many threads give every scheduler of every SM chains to
// interleave.  L is a constant a band, the fastest of L = 1 ... 5 on the
// card (PERF.md; `tools/kernel_variants.py --sweep-sturm`).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // lanes a block
constexpr int kChunk = 512;    // band entries of each array staged a round
constexpr int kLevelsBand1 = 3;  // L, bisection steps a round, band 1
constexpr int kLevelsBand2 = 3;  // band 2

// count(x) over the staged arrays.  Band 1: s0 = d, s1 = e^2 with a leading
// zero.  Band 2: s0 = d shifted by two, s1 = e1 shifted by one, s2 = e2,
// each zero past its end; head = {pivmin, d_0, d_1, e1_0}.  Every thread of
// the block calls it, index or not, for the barriers.
template <bool kBand2>
__device__ int sturm_count(int n, const double* s0, const double* s1,
                           const double* s2, const double* head, double x,
                           double* stage) {
  const double pivmin = head[0];
  int count = 0;
  double q = 1.0, a = 0.0, b = 0.0, c = 0.0;
  if constexpr (kBand2) {
    a = __dsub_rn(head[1], x);
    b = head[3];
    c = n > 1 ? __dsub_rn(head[2], x) : 0.0;
  }
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int len = min(kChunk, n - k0);
    __syncthreads();  // every thread is done with the previous round
    for (int t = threadIdx.x; t < len; t += kThreads) {
      stage[t] = s0[k0 + t];
      stage[kChunk + t] = s1[k0 + t];
      if constexpr (kBand2) stage[2 * kChunk + t] = s2[k0 + t];
    }
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      if constexpr (!kBand2) {
        q = __dsub_rn(__dsub_rn(stage[k], x), __ddiv_rn(stage[kChunk + k], q));
        if (fabs(q) < pivmin) q = -pivmin;
        count += q < 0.0;
      } else {
        const double d_next = stage[k], e1_next = stage[kChunk + k],
                     e2_k = stage[2 * kChunk + k];
        const double piv =
            fabs(a) < pivmin ? (a >= 0.0 ? pivmin : -pivmin) : a;
        count += piv < 0.0;
        const double l1 = __ddiv_rn(b, piv);
        const double l2 = __ddiv_rn(e2_k, piv);
        a = __dsub_rn(c, __dmul_rn(l1, b));
        b = __dsub_rn(e1_next, __dmul_rn(l1, e2_k));
        c = __dsub_rn(__dsub_rn(d_next, x), __dmul_rn(l2, e2_k));
      }
    }
  }
  return count;
}

// The probe of heap node `node` >= 1 below [a, b]: the midpoint of the
// bracket that bisection holds when it reaches the node.  The bits of
// node below its leading one are the path, 0 the lower half, 1 the upper.
__device__ double heap_probe(int node, double a, double b) {
  int depth = 0;
  for (int t = node; t > 1; t >>= 1) ++depth;
  double mid = __dmul_rn(0.5, __dadd_rn(a, b));
  for (int l = depth - 1; l >= 0; --l) {
    if ((node >> l) & 1)
      a = mid;
    else
      b = mid;
    mid = __dmul_rn(0.5, __dadd_rn(a, b));
  }
  return mid;
}

// w[i] = the midpoint of index i's bracket after n_iter halvings, by groups
// of 2^kL lanes, kL halvings a round.  With w0, a bracket that does not hold
// index i at the start (count(a0) > i or count(b0) <= i) returns w0[i]
// instead: the refinement's `valid` mask.
template <bool kBand2, int kL>
__global__ void __launch_bounds__(kThreads)
    sturm_bisect_kernel(int n, const double* s0, const double* s1,
                        const double* s2, const double* head,
                        const double* a0, const double* b0, const double* w0,
                        int n_iter, double* w) {
  constexpr int kGroup = 1 << kL;
  __shared__ double stage[(kBand2 ? 3 : 2) * kChunk];
  const int lane = threadIdx.x % 32;
  const int sub = lane % kGroup;          // the lane's place in its group
  const int first = lane - sub;           // the group's first lane
  const int i = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  const bool live = i < n;
  double a = live ? a0[i] : 0.0, b = live ? b0[i] : 0.0;
  bool valid = true;
  if (w0 != nullptr) {
    const int below =
        sturm_count<kBand2>(n, s0, s1, s2, head, sub == 1 ? b : a, stage);
    const unsigned holds =
        __ballot_sync(0xffffffffu, sub == 1 ? below > i : below <= i) >>
        first;
    valid = (holds & 3u) == 3u;
  }
  for (int done = 0; done < n_iter; done += kL) {
    const int levels = min(kL, n_iter - done);
    const double x =
        sub > 0 && sub < (1 << levels) ? heap_probe(sub, a, b) : a;
    const int below = sturm_count<kBand2>(n, s0, s1, s2, head, x, stage);
    const unsigned above = __ballot_sync(0xffffffffu, below > i) >> first;
    int node = 1;
    for (int l = 0; l < levels; ++l) {
      const double mid = __dmul_rn(0.5, __dadd_rn(a, b));
      const bool lower = (above >> node) & 1u;  // index i lies below mid
      if (lower)
        b = mid;
      else
        a = mid;
      node = 2 * node + !lower;
    }
  }
  if (live && sub == 0)
    w[i] = valid ? __dmul_rn(0.5, __dadd_rn(a, b)) : w0[i];
}

template <bool kBand2, int kL>
int launch(int n, const double* s0, const double* s1, const double* s2,
           const double* head, const double* a0, const double* b0,
           const double* w0, int n_iter, double* w, cudaStream_t s) {
  constexpr int kIndices = kThreads >> kL;  // indices a block
  const dim3 grid((n + kIndices - 1) / kIndices);
  sturm_bisect_kernel<kBand2, kL><<<grid, kThreads, 0, s>>>(
      n, s0, s1, s2, head, a0, b0, w0, n_iter, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// band 1 or 2; w0 may be null (no valid check).  Returns the launch's
// cudaError_t.
extern "C" int eigenexa_sturm_bisect_f64(int n, int band, const double* s0,
                                         const double* s1, const double* s2,
                                         const double* head, const double* a0,
                                         const double* b0, const double* w0,
                                         int n_iter, double* w, void* stream) {
  if (n <= 0) return cudaSuccess;
  if ((band != 1 && band != 2) || n_iter < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return band == 1 ? launch<false, kLevelsBand1>(n, s0, s1, s2, head, a0, b0,
                                                 w0, n_iter, w, s)
                   : launch<true, kLevelsBand2>(n, s0, s1, s2, head, a0, b0,
                                                w0, n_iter, w, s);
}
