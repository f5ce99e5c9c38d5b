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
// real and complex, and the band-2 reflector pairs).
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
