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
// Design: one thread owns one eigenvalue index i and keeps its bracket in
// registers.  Every bisection step runs the whole recurrence over n for the
// thread's midpoint, in the fixed order k = 0 ... n - 1, then keeps the half
// that holds index i.  Each index's bracket evolves alone, so this is
// exactly the JAX update, which probes all midpoints in one scan.  The band
// entries are read by every thread in lockstep: a block stages them through
// shared memory kChunk at a time and reads them as broadcasts.
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
// What bounds it on an H100: nothing the card is short of.  A band-1 step is
// 5 f64 operations (two subtractions, one division, two comparisons), a
// band-2 step 12 (two divisions, three multiplies, four subtractions, three
// comparisons): 2.3e10 operations for a bisection of 70 steps at n = 8192 in
// band 1, 0.69 ms at the 34 TFLOP/s FP64 peak.  But one step waits for the
// previous one's division, and n threads fill only n / 128 blocks, so the
// kernel runs at the latency of one chain of n_iter * n dependent steps per
// thread.  That is the simple kernel asked for first; splitting an index's
// probes over a warp (multisection) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // eigenvalue indices a block
constexpr int kChunk = 512;    // band entries of each array staged a round

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

// w[i] = the midpoint of index i's bracket after n_iter halvings.  With w0,
// a bracket that does not hold index i at the start (count(a0) > i or
// count(b0) <= i) returns w0[i] instead: the refinement's `valid` mask.
template <bool kBand2>
__global__ void __launch_bounds__(kThreads)
    sturm_bisect_kernel(int n, const double* s0, const double* s1,
                        const double* s2, const double* head,
                        const double* a0, const double* b0, const double* w0,
                        int n_iter, double* w) {
  __shared__ double stage[(kBand2 ? 3 : 2) * kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  double a = live ? a0[i] : 0.0, b = live ? b0[i] : 0.0;
  bool valid = true;
  if (w0 != nullptr) {
    const int below_a = sturm_count<kBand2>(n, s0, s1, s2, head, a, stage);
    const int below_b = sturm_count<kBand2>(n, s0, s1, s2, head, b, stage);
    valid = below_a <= i && below_b > i;
  }
  for (int it = 0; it < n_iter; ++it) {
    const double mid = __dmul_rn(0.5, __dadd_rn(a, b));
    if (sturm_count<kBand2>(n, s0, s1, s2, head, mid, stage) > i)
      b = mid;
    else
      a = mid;
  }
  if (live) w[i] = valid ? __dmul_rn(0.5, __dadd_rn(a, b)) : w0[i];
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
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band == 1)
    sturm_bisect_kernel<false><<<grid, kThreads, 0, s>>>(
        n, s0, s1, s2, head, a0, b0, w0, n_iter, w);
  else
    sturm_bisect_kernel<true><<<grid, kThreads, 0, s>>>(
        n, s0, s1, s2, head, a0, b0, w0, n_iter, w);
  return static_cast<int>(cudaGetLastError());
}
