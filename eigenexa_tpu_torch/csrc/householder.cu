// The Householder reflector of one column (dlarfg, zlarfg for complex
// input) as one launch: (v, tau, beta) with (I - tau v v^H)^H x = beta e_p
// on rows p and below, v[p] = 1, v zero above p, beta real.
//
// Not a TPU kernel: the JAX package computes the reflector with jnp ops
// inside the panel's jitted program (eigenexa_tpu/ops/householder.py,
// `householder_vector`), which XLA fuses.  Eager PyTorch on the card issues
// those ops one by one, some 27 launches a column of the reduction, and the
// host's time to issue them sets the reduction's pace (PERF.md section 5).
// So the card form of that function is this one kernel, one launch a
// column, for every caller (the rolled and windowed tridiagonal reductions,
// real and complex).  The band-2 reduction's reflector pair and its update
// of W, and the real column's update of W, further down, are the same kind
// of kernel for the same reason.
//
// What it computes is the plain version's (ops/kernels.py
// `_householder_vector_ref`), step by step:
//   1. scale = max(max_i |x_i|, tiny) over the tail i > p (NaN stays NaN,
//      as torch's amax and clamp_min keep it);
//   2. xnorm = sqrt(sum_i |x_i / scale|^2) * scale, dlarfg's pre-scale, so
//      the squares neither overflow nor underflow;
//   3. one thread: mag = sqrt(Re a^2 [+ Im a^2] + xnorm^2) for a = x[p],
//      beta = -sign(Re a) mag, active = xnorm > 0 (or Im a != 0: zlarfg's
//      phase rotation), tau = (beta - a) / beta and the divisor a - beta
//      where active, tau = 0 and divisor 1 where not;
//   4. v = 0 above p, v[p] = active, v = x / divisor below.
// Each scalar operation of step 3 rounds once (the _rn intrinsics are never
// contracted into an fma), as torch's one-op kernels do; a complex quotient
// follows c10::complex's division (numpy's scaling).  The two sums differ
// from torch's only in their order, so the kernel agrees with the plain
// version to rounding.
//
// What bounds it on an H100: latency, not bytes or operations.  The tail
// is at most n elements (64 KB at n = 8192 f64), just written by the
// column's gather, so it sits in L2; three passes over it (max, sum, v)
// take a few microseconds on one SM.  One block does all: it needs no
// second launch and no atomics for the norm.  The reductions run in a
// fixed order (a strided sum a thread, a butterfly a warp, the warps' sums
// in order), so equal inputs give equal bits on every call.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// the arithmetic of each element type: R its real type, |x|, |x / s|^2 for
// the norm's sum, the quotient x / d, and the element from its parts
struct F32 {
  using T = float;
  using R = float;
  static constexpr bool kComplex = false;
  static constexpr float kTiny = FLT_MIN;
  __device__ static float re(float x) { return x; }
  __device__ static float im(float) { return 0.0f; }
  __device__ static float make(float r, float) { return r; }
  __device__ static float abs(float x) { return fabsf(x); }
  __device__ static float sq_scaled(float x, float s) {
    const float y = x / s;
    return y * y;
  }
  __device__ static float quot(float x, float d) { return x / d; }
  __device__ static float mul_rn(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add_rn(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub_rn(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div_rn(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return sqrtf(a); }
};

struct F64 {
  using T = double;
  using R = double;
  static constexpr bool kComplex = false;
  static constexpr double kTiny = DBL_MIN;
  __device__ static double re(double x) { return x; }
  __device__ static double im(double) { return 0.0; }
  __device__ static double make(double r, double) { return r; }
  __device__ static double abs(double x) { return fabs(x); }
  __device__ static double sq_scaled(double x, double s) {
    const double y = x / s;
    return y * y;
  }
  __device__ static double quot(double x, double d) { return x / d; }
  __device__ static double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
  }
  __device__ static double add_rn(double a, double b) {
    return __dadd_rn(a, b);
  }
  __device__ static double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
  }
  __device__ static double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
  }
  __device__ static double sqrt(double a) { return ::sqrt(a); }
};

// c10::complex's division, (a + bi) / (c + di), scaled by the larger of
// |c| and |d| (numpy's); a real divisor d = 0 gives x * (1 / c)
template <typename C, typename R>
__device__ C complex_quot(C x, C y) {
  const R a = x.x, b = x.y, c = y.x, d = y.y;
  const R abs_c = c < R(0) ? -c : c, abs_d = d < R(0) ? -d : d;
  C out;
  if (abs_c >= abs_d) {
    if (abs_c == R(0) && abs_d == R(0)) {
      out.x = a / abs_c;
      out.y = b / abs_d;
    } else {
      const R rat = d / c;
      const R scl = R(1) / (c + d * rat);
      out.x = (a + b * rat) * scl;
      out.y = (b - a * rat) * scl;
    }
  } else {
    const R rat = c / d;
    const R scl = R(1) / (d + c * rat);
    out.x = (a * rat + b) * scl;
    out.y = (b * rat - a) * scl;
  }
  return out;
}

struct C64 {
  using T = float2;
  using R = float;
  static constexpr bool kComplex = true;
  static constexpr float kTiny = FLT_MIN;
  __device__ static float re(float2 x) { return x.x; }
  __device__ static float im(float2 x) { return x.y; }
  __device__ static float2 make(float r, float i) { return make_float2(r, i); }
  __device__ static float abs(float2 x) { return hypotf(x.x, x.y); }
  __device__ static float sq_scaled(float2 x, float s) {
    const float2 y = complex_quot<float2, float>(x, make_float2(s, 0.0f));
    return y.x * y.x + y.y * y.y;
  }
  __device__ static float2 quot(float2 x, float2 d) {
    return complex_quot<float2, float>(x, d);
  }
  __device__ static float mul_rn(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add_rn(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sqrt(float a) { return sqrtf(a); }
};

struct C128 {
  using T = double2;
  using R = double;
  static constexpr bool kComplex = true;
  static constexpr double kTiny = DBL_MIN;
  __device__ static double re(double2 x) { return x.x; }
  __device__ static double im(double2 x) { return x.y; }
  __device__ static double2 make(double r, double i) {
    return make_double2(r, i);
  }
  __device__ static double abs(double2 x) { return hypot(x.x, x.y); }
  __device__ static double sq_scaled(double2 x, double s) {
    const double2 y = complex_quot<double2, double>(x, make_double2(s, 0.0));
    return y.x * y.x + y.y * y.y;
  }
  __device__ static double2 quot(double2 x, double2 d) {
    return complex_quot<double2, double>(x, d);
  }
  __device__ static double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
  }
  __device__ static double add_rn(double a, double b) {
    return __dadd_rn(a, b);
  }
  __device__ static double sqrt(double a) { return ::sqrt(a); }
};

// max that keeps a NaN, as torch's amax and clamp_min do (fmax drops it)
struct MaxNan {
  template <typename R>
  __device__ R operator()(R a, R b) const {
    return a != a ? a : (b != b ? b : (a > b ? a : b));
  }
};

struct Plus {
  template <typename R>
  __device__ R operator()(R a, R b) const {
    return a + b;
  }
};

// The block's reduction of one value a thread, in a fixed order: a
// butterfly within each warp, then the warps' results in warp order, read
// by every thread.  `partial` is free again when it returns.
template <typename R, typename Op>
__device__ R block_reduce(R value, R* partial, Op op) {
  for (int mask = 16; mask > 0; mask >>= 1)
    value = op(value, __shfl_xor_sync(0xffffffffu, value, mask));
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = value;
  __syncthreads();
  R total = partial[0];
  for (int w = 1; w < kWarps; ++w) total = op(total, partial[w]);
  __syncthreads();
  return total;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    householder_vector_kernel(int m, int p,
                              const typename E::T* __restrict__ x,
                              typename E::T* __restrict__ v,
                              typename E::T* tau, typename E::R* beta) {
  using T = typename E::T;
  using R = typename E::R;
  __shared__ R partial[kWarps];
  __shared__ T divisor;
  __shared__ bool active;
  const int tail = p + 1;

  R big = R(0);
  for (int i = tail + threadIdx.x; i < m; i += kThreads)
    big = MaxNan()(big, E::abs(x[i]));
  const R scale = MaxNan()(block_reduce(big, partial, MaxNan()), E::kTiny);

  R sum = R(0);
  for (int i = tail + threadIdx.x; i < m; i += kThreads)
    sum += E::sq_scaled(x[i], scale);
  sum = block_reduce(sum, partial, Plus());

  if (threadIdx.x == 0) {
    const T alpha = x[p];
    const R ar = E::re(alpha), ai = E::im(alpha);
    const R xnorm = tail < m ? E::mul_rn(E::sqrt(sum), scale) : R(0);
    R mag2 = E::mul_rn(ar, ar);
    if constexpr (E::kComplex) mag2 = E::add_rn(mag2, E::mul_rn(ai, ai));
    const R mag = E::sqrt(E::add_rn(mag2, E::mul_rn(xnorm, xnorm)));
    const bool on = xnorm > R(0) || (E::kComplex && ai != R(0));
    const R b = ar >= R(0) ? -mag : mag;
    const R safe = on ? b : R(1);
    // (safe - alpha) / safe and alpha - safe, safe taken as safe + 0i
    const T t = E::quot(E::make(safe - ar, R(0) - ai), E::make(safe, R(0)));
    *tau = on ? t : E::make(R(0), R(0));
    *beta = on ? b : ar;
    divisor = on ? E::make(ar - safe, ai - R(0)) : E::make(R(1), R(0));
    active = on;
  }
  __syncthreads();

  const T zero = E::make(R(0), R(0));
  const T pivot = E::make(active ? R(1) : R(0), R(0));
  const T d = divisor;
  for (int i = threadIdx.x; i < m; i += kThreads)
    v[i] = i < p ? zero : (i == p ? pivot : E::quot(x[i], d));
}

template <typename E>
int launch(int m, int p, const typename E::T* x, typename E::T* v,
           typename E::T* tau, typename E::R* beta, void* stream) {
  if (m <= 0 || p < 0 || p >= m) return cudaErrorInvalidValue;
  householder_vector_kernel<E><<<1, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      m, p, x, v, tau, beta);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The band-2 reflector pair of eigen_sx's PRD-BLK as one launch, for f32 and
// f64.  Its plain version (ops/kernels.py `_pair_reflectors_ref`, the
// tall-skinny QR of src/eigen_prd_t4x.F:83) is some 43 eager ops a pair,
// two column reflectors among them; the host's time to issue them was more
// than half of a pair's (PERF.md section 5).  Step by step, for the pair's
// columns x0 = x[:, 0] and x1 = x[:, 1] and the pivot p:
//   1. a0, a1: x0 and x1 with the rows above p taken as zero;
//   2. CholeskyQR2, twice: s = (a0 . a1) / (a0 . a0), 0 where a0 . a0 is
//      not positive, and a1 = a1 - s a0;
//   3. reflector 0 of a0 at the pivot p: the column reflector's steps 1-4
//      above, real;
//   4. H0 applied to a1 analytically: g = tau0 (-beta0 a1[p] / d), the
//      divisor d = a0[p] - beta0 where tau0 != 0 and 1 where not, and
//      c1 = a1 - g v0;
//   5. reflector 1 of c1 at the pivot p + 1 (none where p + 1 = m);
//   6. T = [[tau0, -tau0 tau1 (v0 . v1)], [0, tau1]], with H0 H1 =
//      I - V T V^T.
// Each elementwise and scalar step rounds once (_rn), as torch's one-op
// kernels do; the six sums (a0 . a0, a0 . a1 twice, the two reflectors'
// scaled norms, v0 . v1) run in the block's fixed order where torch takes
// cuBLAS's, so the kernel agrees with the plain version to rounding.  a1
// and c1 are never stored: each pass computes them again from x, so x is
// only read and V only written.

// max (NaN kept) and sum over the block of f(i) for the rows [lo, m), each
// thread's rows strided by kThreads
template <typename R, typename F>
__device__ R rows_max(int lo, int m, F f, R* partial) {
  R big = R(0);
  for (int i = lo + threadIdx.x; i < m; i += kThreads)
    big = MaxNan()(big, f(i));
  return block_reduce(big, partial, MaxNan());
}

template <typename R, typename F>
__device__ R rows_sum(int lo, int m, F f, R* partial) {
  R sum = R(0);
  for (int i = lo + threadIdx.x; i < m; i += kThreads) sum += f(i);
  return block_reduce(sum, partial, Plus());
}

// The reflector of the real column c(i) at the pivot q: out[0] tau,
// out[1] beta, out[2] the divisor of v below the pivot, out[3] v[q] (1 where
// active, 0 where not); q >= m gives no reflector (0, 0, 1, 0).  Every
// thread returns after the scalars are set.
template <typename E, typename F>
__device__ void pair_column_reflector(int m, int q, F c,
                                      typename E::R* partial,
                                      typename E::R* out) {
  using R = typename E::R;
  const int tail = q + 1;
  R sum = R(0), scale = R(1);
  if (q < m) {
    scale = MaxNan()(rows_max<R>(tail, m, [&](int i) { return E::abs(c(i)); },
                                 partial),
                     E::kTiny);
    sum = rows_sum<R>(
        tail, m, [&](int i) { return E::sq_scaled(c(i), scale); }, partial);
  }
  if (threadIdx.x == 0) {
    if (q < m) {
      const R a = c(q);
      const R xnorm = tail < m ? E::mul_rn(E::sqrt(sum), scale) : R(0);
      const R mag =
          E::sqrt(E::add_rn(E::mul_rn(a, a), E::mul_rn(xnorm, xnorm)));
      const bool on = xnorm > R(0);
      const R b = a >= R(0) ? -mag : mag;
      const R safe = on ? b : R(1);
      out[0] = on ? E::div_rn(E::sub_rn(safe, a), safe) : R(0);
      out[1] = on ? b : a;
      out[2] = on ? E::sub_rn(a, safe) : R(1);
      out[3] = on ? R(1) : R(0);
    } else {
      out[0] = out[1] = out[3] = R(0);
      out[2] = R(1);
    }
  }
  __syncthreads();
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    pair_reflectors_kernel(int m, int p, const typename E::T* __restrict__ x,
                           long long ldx, typename E::T* __restrict__ v,
                           long long ldv, typename E::T* __restrict__ tau,
                           typename E::T* __restrict__ t) {
  using R = typename E::R;
  __shared__ R partial[kWarps];
  __shared__ R r0[4], r1[4];  // each reflector's tau, beta, divisor, v[q]
  __shared__ R shift;         // g of step 4
  const int q = p + 1;
  // step 1 (read only at rows i >= p)
  auto a0 = [&](int i) { return x[i * ldx]; };
  auto a1 = [&](int i) { return x[i * ldx + 1]; };

  // step 2
  const R t11 = rows_sum<R>(p, m, [&](int i) { return a0(i) * a0(i); },
                            partial);
  const bool pos = t11 > R(0);
  const R safe = pos ? t11 : R(1);
  const R d1 = rows_sum<R>(p, m, [&](int i) { return a0(i) * a1(i); },
                           partial);
  const R s1 = pos ? E::div_rn(d1, safe) : R(0);
  auto b1 = [&](int i) { return E::sub_rn(a1(i), E::mul_rn(s1, a0(i))); };
  const R d2 = rows_sum<R>(p, m, [&](int i) { return a0(i) * b1(i); },
                           partial);
  const R s2 = pos ? E::div_rn(d2, safe) : R(0);
  auto b2 = [&](int i) { return E::sub_rn(b1(i), E::mul_rn(s2, a0(i))); };

  // step 3
  pair_column_reflector<E>(m, p, a0, partial, r0);
  const R tau0 = r0[0], div0 = r0[2], piv0 = r0[3];
  auto v0 = [&](int i) {
    return i < p ? R(0) : (i == p ? piv0 : E::quot(a0(i), div0));
  };
  for (int i = threadIdx.x; i < m; i += kThreads) v[i * ldv] = v0(i);

  // step 4
  if (threadIdx.x == 0) {
    const R beta0 = r0[1];
    const R d = tau0 != R(0) ? E::sub_rn(a0(p), beta0) : R(1);
    shift = E::mul_rn(tau0, E::div_rn(E::mul_rn(-beta0, b2(p)), d));
  }
  __syncthreads();
  const R g = shift;
  auto c1 = [&](int i) { return E::sub_rn(b2(i), E::mul_rn(g, v0(i))); };

  // step 5
  pair_column_reflector<E>(m, q, c1, partial, r1);
  const R tau1 = r1[0], div1 = r1[2], piv1 = r1[3];
  auto v1 = [&](int i) {
    return i < q ? R(0) : (i == q ? piv1 : E::quot(c1(i), div1));
  };
  for (int i = threadIdx.x; i < m; i += kThreads) v[i * ldv + 1] = v1(i);

  // step 6
  const R dot = rows_sum<R>(q, m, [&](int i) { return v0(i) * v1(i); },
                            partial);
  if (threadIdx.x == 0) {
    tau[0] = tau0;
    tau[1] = tau1;
    t[0] = tau0;
    t[1] = E::mul_rn(E::mul_rn(-tau0, tau1), dot);
    t[2] = R(0);
    t[3] = tau1;
  }
}

template <typename E>
int launch_pair(int m, int p, const typename E::T* x, long long ldx,
                typename E::T* v, long long ldv, typename E::T* tau,
                typename E::T* t, void* stream) {
  if (m <= 0 || p < 0 || p >= m || ldx < 2 || ldv < 2)
    return cudaErrorInvalidValue;
  pair_reflectors_kernel<E><<<1, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      m, p, x, ldx, v, ldv, tau, t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// W's two columns for the reflector pair, and the pair's stores, as one
// call of three launches for f32 and f64: the plain version (ops/kernels.py
// `_pair_update_ref`, the 2x2 coupling of src/eigen_prd.F:363) is some 16
// eager ops a pair, among them eight narrow products that cuBLASLt splits.
// For the panel's earlier columns U and W (c0 each, row i of U at
// u[i * ldu], of W at w[i * ldu]), the pair's V, B.V and T:
//   1. C_w = W^T V and C_u = U^T V (c0 x 2 each);
//   2. Q = B.V - U C_w - W C_u, P = Q T, G = V^T P;
//   3. S = T^T G and W's columns P - (V S) / 2, zero on the rows before
//      `j0` (the windowed frame's stale rows); V's columns stored beside
//      U, W's beside W.
// The rows are cut into `blocks` slabs of `slab` rows, a block each, and
// each step is one launch over them: step 1 leaves a slab's sums of C in
// `part`, step 2 adds the slabs' sums in slab order and leaves a slab's
// sums of G in `gpart`, step 3 adds those in slab order.  Within a block,
// step 1 is a warp's rows against 32 columns a lane, the warps' sums added
// in warp order; step 2 a warp's rows, a row's sums over the c0 columns a
// lane's columns in order and then the warp's butterfly.  So the sums run
// in one fixed order, equal inputs give equal bits, and each subtraction
// and the halving round once, as torch's one-op kernels: the kernel agrees
// with the plain version to rounding.  U and W are the panel's at most 2 nb
// columns of the live rows; spread over the slabs, each SM reads a few
// hundred KB.

constexpr int kMaxPairCols = 256;  // most earlier columns c0 it takes
constexpr int kRowsInFlight = 8;   // rows a warp loads before it sums
constexpr int kSlabRows = 128;     // least rows a slab
constexpr int kMaxSlabs = 64;      // most slabs

// the slab of rows [first, last) of this block
__device__ inline void slab_rows(int m, int slab, int& first, int& last) {
  first = blockIdx.x * slab;
  last = first + slab < m ? first + slab : m;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    pair_update_dots(int m, int slab, int c0,
                     const typename E::T* __restrict__ u,
                     const typename E::T* __restrict__ w, long long ldu,
                     const typename E::T* __restrict__ v, long long ldv,
                     typename E::T* __restrict__ part) {
  using R = typename E::R;
  __shared__ R sums[kWarps][32][4];  // a warp's sums of one chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int first, last;
  slab_rows(m, slab, first, last);
  R* out = part + size_t(blockIdx.x) * c0 * 4;
  for (int base = 0; base < c0; base += 32) {
    const int j = base + lane;
    R acc[4] = {R(0), R(0), R(0), R(0)};
    for (int i0 = first + warp; i0 < last; i0 += kRowsInFlight * kWarps) {
      R x[kRowsInFlight][4];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int i = i0 + r * kWarps;
        const bool in = i < last && j < c0;
        x[r][0] = in ? w[i * ldu + j] : R(0);
        x[r][1] = in ? u[i * ldu + j] : R(0);
        x[r][2] = in ? v[i * ldv] : R(0);
        x[r][3] = in ? v[i * ldv + 1] : R(0);
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        acc[0] += x[r][0] * x[r][2];
        acc[1] += x[r][0] * x[r][3];
        acc[2] += x[r][1] * x[r][2];
        acc[3] += x[r][1] * x[r][3];
      }
    }
    for (int k = 0; k < 4; ++k) sums[warp][lane][k] = acc[k];
    __syncthreads();
    if (threadIdx.x < 128) {
      const int col = threadIdx.x / 4, k = threadIdx.x % 4;
      if (base + col < c0) {
        R total = sums[0][col][k];
        for (int x = 1; x < kWarps; ++x) total += sums[x][col][k];
        out[(base + col) * 4 + k] = total;
      }
    }
    __syncthreads();
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    pair_update_rows(int m, int slab, int blocks, int c0,
                     const typename E::T* __restrict__ bv, long long ldb,
                     const typename E::T* u, typename E::T* w, long long ldu,
                     const typename E::T* __restrict__ v, long long ldv,
                     const typename E::T* __restrict__ t,
                     const typename E::T* __restrict__ part,
                     typename E::T* __restrict__ gpart) {
  using R = typename E::R;
  __shared__ R partial[kWarps];
  __shared__ R cwu[kMaxPairCols][4];  // W^T V, then U^T V, by columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const R t00 = t[0], t01 = t[1], t10 = t[2], t11 = t[3];
  int first, last;
  slab_rows(m, slab, first, last);
  for (int e = threadIdx.x; e < c0 * 4; e += kThreads) {
    R total = part[e];
    for (int b = 1; b < blocks; ++b) total += part[size_t(b) * c0 * 4 + e];
    cwu[e / 4][e % 4] = total;
  }
  __syncthreads();

  // a warp a row, its lanes over the columns, kRowsInFlight rows at a
  // time; lane r finishes row r of them: P into W's new columns for now
  typename E::T* wo = w + c0;
  R g00 = R(0), g01 = R(0), g10 = R(0), g11 = R(0);
  for (int i0 = first + warp; i0 < last; i0 += kRowsInFlight * kWarps) {
    const int mine = i0 + lane * kWarps;  // the row this lane finishes
    const bool finish = lane < kRowsInFlight && mine < last;
    R b0 = R(0), b1 = R(0), v0 = R(0), v1 = R(0);
    if (finish) {
      b0 = bv[mine * ldb];
      b1 = bv[mine * ldb + 1];
      v0 = v[mine * ldv];
      v1 = v[mine * ldv + 1];
    }
    R a[kRowsInFlight][4];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int i = i0 + r * kWarps;
      a[r][0] = a[r][1] = a[r][2] = a[r][3] = R(0);
      if (i < last) {
        for (int jj = lane; jj < c0; jj += 32) {
          const R uij = u[i * ldu + jj], wij = w[i * ldu + jj];
          a[r][0] += uij * cwu[jj][0];
          a[r][1] += uij * cwu[jj][1];
          a[r][2] += wij * cwu[jj][2];
          a[r][3] += wij * cwu[jj][3];
        }
      }
    }
    R s[4] = {R(0), R(0), R(0), R(0)};
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r)
      for (int k = 0; k < 4; ++k) {
        R x = a[r][k];
        for (int mask = 16; mask > 0; mask >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, mask);
        s[k] = lane == r ? x : s[k];
      }
    if (finish) {
      R q0 = b0, q1 = b1;
      if (c0) {
        q0 = E::sub_rn(E::sub_rn(q0, s[0]), s[2]);
        q1 = E::sub_rn(E::sub_rn(q1, s[1]), s[3]);
      }
      const R p0 = q0 * t00 + q1 * t10, p1 = q0 * t01 + q1 * t11;
      wo[mine * ldu] = p0;
      wo[mine * ldu + 1] = p1;
      g00 += v0 * p0;
      g01 += v0 * p1;
      g10 += v1 * p0;
      g11 += v1 * p1;
    }
  }
  g00 = block_reduce(g00, partial, Plus());
  g01 = block_reduce(g01, partial, Plus());
  g10 = block_reduce(g10, partial, Plus());
  g11 = block_reduce(g11, partial, Plus());
  if (threadIdx.x == 0) {
    R* out = gpart + size_t(blockIdx.x) * 4;
    out[0] = g00;
    out[1] = g01;
    out[2] = g10;
    out[3] = g11;
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    pair_update_store(int m, int slab, int blocks, int c0, int j0,
                      typename E::T* u, typename E::T* w, long long ldu,
                      const typename E::T* __restrict__ v, long long ldv,
                      const typename E::T* __restrict__ t,
                      const typename E::T* __restrict__ gpart) {
  using R = typename E::R;
  const R t00 = t[0], t01 = t[1], t10 = t[2], t11 = t[3];
  R g[4];
  for (int k = 0; k < 4; ++k) {
    g[k] = gpart[k];
    for (int b = 1; b < blocks; ++b) g[k] += gpart[size_t(b) * 4 + k];
  }
  const R s00 = t00 * g[0] + t10 * g[2], s01 = t00 * g[1] + t10 * g[3];
  const R s10 = t01 * g[0] + t11 * g[2], s11 = t01 * g[1] + t11 * g[3];
  typename E::T* wo = w + c0;
  typename E::T* uo = u + c0;
  int first, last;
  slab_rows(m, slab, first, last);
  for (int i = first + threadIdx.x; i < last; i += kThreads) {
    const R v0 = v[i * ldv], v1 = v[i * ldv + 1];
    const R x0 = v0 * s00 + v1 * s10, x1 = v0 * s01 + v1 * s11;
    const bool live = i >= j0;
    const R p0 = wo[i * ldu], p1 = wo[i * ldu + 1];
    wo[i * ldu] = live ? E::sub_rn(p0, E::mul_rn(R(0.5), x0)) : R(0);
    wo[i * ldu + 1] = live ? E::sub_rn(p1, E::mul_rn(R(0.5), x1)) : R(0);
    uo[i * ldu] = v0;
    uo[i * ldu + 1] = v1;
  }
}

// the slabs of m rows: (rows a slab, slabs)
inline void pair_slabs(int m, int& slab, int& blocks) {
  blocks = (m + kSlabRows - 1) / kSlabRows;
  if (blocks > kMaxSlabs) blocks = kMaxSlabs;
  slab = (m + blocks - 1) / blocks;
  blocks = (m + slab - 1) / slab;
}

template <typename E>
int launch_update(int m, int c0, int j0, const typename E::T* bv,
                  long long ldb, typename E::T* u, typename E::T* w,
                  long long ldu, const typename E::T* v, long long ldv,
                  const typename E::T* t, typename E::T* scratch,
                  void* stream) {
  if (m <= 0 || c0 < 0 || c0 > kMaxPairCols || j0 < 0 || ldb < 2 ||
      ldu < c0 + 2 || ldv < 2)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int slab, blocks;
  pair_slabs(m, slab, blocks);
  typename E::T* part = scratch;
  typename E::T* gpart = scratch + size_t(kMaxSlabs) * c0 * 4;
  if (c0) {
    pair_update_dots<E><<<blocks, kThreads, 0, s>>>(m, slab, c0, u, w, ldu,
                                                    v, ldv, part);
  }
  pair_update_rows<E><<<blocks, kThreads, 0, s>>>(
      m, slab, blocks, c0, bv, ldb, u, w, ldu, v, ldv, t, part, gpart);
  pair_update_store<E><<<blocks, kThreads, 0, s>>>(
      m, slab, blocks, c0, j0, u, w, ldu, v, ldv, t, gpart);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tridiagonal column's W, and the column's stores, as one call of three
// launches for f32 and f64: the pair's update above with one column for two
// and T = [tau].  The plain version (ops/kernels.py `_column_update_ref`,
// eigen_trd_au and eigen_trd_compute_v, src/eigen_trd_t2.F:161 and
// src/eigen_trd_t6_3.F:85) is some 19 eager ops a column.  For the panel's
// first c0 columns of U and W (row i of U at u[i * ldu], of W at
// w[i * ldu]), the column's v, B.v and tau (read on the card):
//   1. c_w = W^T v and c_u = U^T v (c0 each);
//   2. q = B.v - U c_w - W c_u, g = v^T q;
//   3. w = tau q - (tau tau / 2) g v, zero on the rows before `j0`; v
//      stored as U's column j, w as W's.
// The slabs, the fixed order of every sum and the roundings are the pair's:
// step 1 leaves a slab's sums in `part`, step 2 adds the slabs' sums in slab
// order, keeps q in W's column j and leaves a slab's sum of g in `gpart`,
// step 3 adds those in slab order.  Each subtraction and each product of the
// scalars and of step 3 rounds once, as torch's one-op kernels, so the
// kernel agrees with the plain version to rounding.

template <typename E>
__global__ void __launch_bounds__(kThreads)
    column_update_dots(int m, int slab, int c0,
                       const typename E::T* __restrict__ u,
                       const typename E::T* __restrict__ w, long long ldu,
                       const typename E::T* __restrict__ v,
                       typename E::T* __restrict__ part) {
  using R = typename E::R;
  __shared__ R sums[kWarps][32][2];  // a warp's sums of one chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int first, last;
  slab_rows(m, slab, first, last);
  R* out = part + size_t(blockIdx.x) * c0 * 2;
  for (int base = 0; base < c0; base += 32) {
    const int j = base + lane;
    R acc[2] = {R(0), R(0)};
    for (int i0 = first + warp; i0 < last; i0 += kRowsInFlight * kWarps) {
      R x[kRowsInFlight][3];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int i = i0 + r * kWarps;
        const bool in = i < last && j < c0;
        x[r][0] = in ? w[i * ldu + j] : R(0);
        x[r][1] = in ? u[i * ldu + j] : R(0);
        x[r][2] = in ? v[i] : R(0);
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        acc[0] += x[r][0] * x[r][2];
        acc[1] += x[r][1] * x[r][2];
      }
    }
    sums[warp][lane][0] = acc[0];
    sums[warp][lane][1] = acc[1];
    __syncthreads();
    if (threadIdx.x < 64) {
      const int col = threadIdx.x / 2, k = threadIdx.x % 2;
      if (base + col < c0) {
        R total = sums[0][col][k];
        for (int x = 1; x < kWarps; ++x) total += sums[x][col][k];
        out[(base + col) * 2 + k] = total;
      }
    }
    __syncthreads();
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    column_update_rows(int m, int slab, int blocks, int c0, int j,
                       const typename E::T* __restrict__ bv,
                       const typename E::T* u, typename E::T* w,
                       long long ldu, const typename E::T* __restrict__ v,
                       const typename E::T* __restrict__ part,
                       typename E::T* __restrict__ gpart) {
  using R = typename E::R;
  __shared__ R partial[kWarps];
  __shared__ R cwu[kMaxPairCols][2];  // W^T v, then U^T v, by columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int first, last;
  slab_rows(m, slab, first, last);
  for (int e = threadIdx.x; e < c0 * 2; e += kThreads) {
    R total = part[e];
    for (int b = 1; b < blocks; ++b) total += part[size_t(b) * c0 * 2 + e];
    cwu[e / 2][e % 2] = total;
  }
  __syncthreads();

  // a warp a row, its lanes over the columns, kRowsInFlight rows at a
  // time; lane r finishes row r of them: q into W's column j for now
  typename E::T* wo = w + j;
  R g = R(0);
  for (int i0 = first + warp; i0 < last; i0 += kRowsInFlight * kWarps) {
    const int mine = i0 + lane * kWarps;  // the row this lane finishes
    const bool finish = lane < kRowsInFlight && mine < last;
    R s[2] = {R(0), R(0)};
    if (c0) {
      R a[kRowsInFlight][2];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int i = i0 + r * kWarps;
        a[r][0] = a[r][1] = R(0);
        if (i < last) {
          for (int jj = lane; jj < c0; jj += 32) {
            a[r][0] += u[i * ldu + jj] * cwu[jj][0];
            a[r][1] += w[i * ldu + jj] * cwu[jj][1];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        for (int k = 0; k < 2; ++k) {
          R x = a[r][k];
          for (int mask = 16; mask > 0; mask >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, mask);
          s[k] = lane == r ? x : s[k];
        }
    }
    if (finish) {
      R q = bv[mine];
      if (c0) q = E::sub_rn(E::sub_rn(q, s[0]), s[1]);
      wo[mine * ldu] = q;
      g += v[mine] * q;
    }
  }
  g = block_reduce(g, partial, Plus());
  if (threadIdx.x == 0) gpart[blockIdx.x] = g;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    column_update_store(int m, int slab, int blocks, int j, int j0,
                        typename E::T* u, typename E::T* w, long long ldu,
                        const typename E::T* __restrict__ v,
                        const typename E::T* __restrict__ tau,
                        const typename E::T* __restrict__ gpart) {
  using R = typename E::R;
  R g = gpart[0];
  for (int b = 1; b < blocks; ++b) g += gpart[b];
  const R t = *tau;
  // (tau tau / 2) g, each product rounded once as the plain version's
  const R coef = E::mul_rn(E::mul_rn(E::mul_rn(t, t), R(0.5)), g);
  typename E::T* wo = w + j;
  typename E::T* uo = u + j;
  int first, last;
  slab_rows(m, slab, first, last);
  for (int i = first + threadIdx.x; i < last; i += kThreads) {
    const R vi = v[i];
    const R q = wo[i * ldu];
    wo[i * ldu] =
        i >= j0 ? E::sub_rn(E::mul_rn(t, q), E::mul_rn(coef, vi)) : R(0);
    uo[i * ldu] = vi;
  }
}

template <typename E>
int launch_column(int m, int c0, int j, int j0, const typename E::T* bv,
                  typename E::T* u, typename E::T* w, long long ldu,
                  const typename E::T* v, const typename E::T* tau,
                  typename E::T* scratch, void* stream) {
  if (m <= 0 || c0 < 0 || c0 > kMaxPairCols || c0 > j || ldu <= j ||
      j0 < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int slab, blocks;
  pair_slabs(m, slab, blocks);
  typename E::T* part = scratch;
  typename E::T* gpart = scratch + size_t(kMaxSlabs) * c0 * 2;
  if (c0) {
    column_update_dots<E><<<blocks, kThreads, 0, s>>>(m, slab, c0, u, w, ldu,
                                                      v, part);
  }
  column_update_rows<E><<<blocks, kThreads, 0, s>>>(
      m, slab, blocks, c0, j, bv, u, w, ldu, v, part, gpart);
  column_update_store<E><<<blocks, kThreads, 0, s>>>(
      m, slab, blocks, j, j0, u, w, ldu, v, tau, gpart);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and v: m contiguous elements; tau: one element; beta: one real.  The
// pivot p lies in [0, m).  Each returns the launch's cudaError_t.
extern "C" int eigenexa_householder_vector_f32(int m, int p, const float* x,
                                               float* v, float* tau,
                                               float* beta, void* stream) {
  return launch<F32>(m, p, x, v, tau, beta, stream);
}

extern "C" int eigenexa_householder_vector_f64(int m, int p, const double* x,
                                               double* v, double* tau,
                                               double* beta, void* stream) {
  return launch<F64>(m, p, x, v, tau, beta, stream);
}

extern "C" int eigenexa_householder_vector_c64(int m, int p, const float2* x,
                                               float2* v, float2* tau,
                                               float* beta, void* stream) {
  return launch<C64>(m, p, x, v, tau, beta, stream);
}

extern "C" int eigenexa_householder_vector_c128(int m, int p,
                                                const double2* x, double2* v,
                                                double2* tau, double* beta,
                                                void* stream) {
  return launch<C128>(m, p, x, v, tau, beta, stream);
}

// The reflector pair: x and v are m rows of two adjacent elements, row i at
// x[i * ldx] and v[i * ldv]; tau two elements, t four (T by rows).  The
// first pivot p lies in [0, m).  Each returns the launch's cudaError_t.
extern "C" int eigenexa_pair_reflectors_f32(int m, int p, const float* x,
                                            long long ldx, float* v,
                                            long long ldv, float* tau,
                                            float* t, void* stream) {
  return launch_pair<F32>(m, p, x, ldx, v, ldv, tau, t, stream);
}

extern "C" int eigenexa_pair_reflectors_f64(int m, int p, const double* x,
                                            long long ldx, double* v,
                                            long long ldv, double* tau,
                                            double* t, void* stream) {
  return launch_pair<F64>(m, p, x, ldx, v, ldv, tau, t, stream);
}

// The pair's update: rows of b_v, v at bv[i * ldb], v[i * ldv] (two
// adjacent elements); the panel's U and W at u and w, rows ldu apart, with
// c0 earlier columns each; t four elements (T by rows); scratch
// 64 * (4 * c0 + 4) elements.  Writes U's and W's columns c0 and c0 + 1;
// W's rows 0 to j0 - 1 are zero.  At most 256 earlier columns.  Each
// returns the first launch error's cudaError_t.
extern "C" int eigenexa_pair_update_f32(int m, int c0, int j0,
                                        const float* bv, long long ldb,
                                        float* u, float* w, long long ldu,
                                        const float* v, long long ldv,
                                        const float* t, float* scratch,
                                        void* stream) {
  return launch_update<F32>(m, c0, j0, bv, ldb, u, w, ldu, v, ldv, t,
                            scratch, stream);
}

extern "C" int eigenexa_pair_update_f64(int m, int c0, int j0,
                                        const double* bv, long long ldb,
                                        double* u, double* w, long long ldu,
                                        const double* v, long long ldv,
                                        const double* t, double* scratch,
                                        void* stream) {
  return launch_update<F64>(m, c0, j0, bv, ldb, u, w, ldu, v, ldv, t,
                            scratch, stream);
}

// The column's update: b_v and v m contiguous elements; the panel's U and W
// at u and w, rows ldu apart, of which the first c0 columns correct q; tau
// one element; scratch 64 * (2 * c0 + 1) elements.  Writes U's and W's
// column j (c0 <= j < ldu); W's rows 0 to j0 - 1 are zero.  At most 256
// correcting columns.  Each returns the first launch error's cudaError_t.
extern "C" int eigenexa_column_update_f32(int m, int c0, int j, int j0,
                                          const float* bv, float* u,
                                          float* w, long long ldu,
                                          const float* v, const float* tau,
                                          float* scratch, void* stream) {
  return launch_column<F32>(m, c0, j, j0, bv, u, w, ldu, v, tau, scratch,
                            stream);
}

extern "C" int eigenexa_column_update_f64(int m, int c0, int j, int j0,
                                          const double* bv, double* u,
                                          double* w, long long ldu,
                                          const double* v, const double* tau,
                                          double* scratch, void* stream) {
  return launch_column<F64>(m, c0, j, j0, bv, u, w, ldu, v, tau, scratch,
                            stream);
}
