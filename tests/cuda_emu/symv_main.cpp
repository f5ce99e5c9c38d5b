// Runs the kernels of csrc/symv_lower.cu (as rewritten into kern.cpp by the
// test) on CPU threads and holds every case against a plain loop in long
// double: Q = S X over the window's lower triangle S (mirrored), minus the
// panel's corrections U (W^T x) + W (U^T x) where a panel is given.  The
// upper triangle and everything outside the view hold garbage (1e6, NaN),
// which must never reach the result.  Checked a case:
//   * every row inside the window within c * sqrt(m - w) * max|S| * max|X|
//     (+ 2 nb * max|P| * max|g| with a panel) of the loop, c = 1e-5 in f32
//     and 1e-13 in f64: the kernel sums in another order;
//   * rows above the window exactly +0; nothing written past Q or past the
//     scratch the call was given;
//   * a second call on the same, reused, scratch gives the same bits.
// The argument picks the element type, f32 (the default) or f64.  Prints one
// line a case, with a hash of Q's bits (the test compares the hashes of two
// runs with other SM counts: the bits must not depend on the grid), and
// "ALL OK" or "FAIL"; exits non-zero on a failure.
#include "kern.cpp"

#include <cmath>
#include <cstdio>
#include <cstring>
#include <limits>
#include <random>
#include <string>

static std::mt19937 rng(11);

template <typename T>
static T* aligned(std::vector<T>& v, int offset) {
  return reinterpret_cast<T*>(
             (reinterpret_cast<uintptr_t>(v.data()) + 15) & ~uintptr_t(15)) +
         offset;
}

template <typename T>
static int call(int m, int w, int nc, const T* b, long long ldb, const T* x,
                long long ldx, T* q, long long ldq, T* scratch, long long len,
                const T* panel, long long ldp, int half, int nb) {
  if constexpr (sizeof(T) == 4)
    return eigenexa_symv_lower_f32(m, w, nc, b, ldb, x, ldx, q, ldq, scratch,
                                   len, panel, ldp, half, nb, nullptr);
  else
    return eigenexa_symv_lower_f64(m, w, nc, b, ldb, x, ldx, q, ldq, scratch,
                                   len, panel, ldp, half, nb, nullptr);
}

// B: (m, m) view with leading dimension ldb, `ob` elements past a 16-byte
// boundary; window start w; X (m, nc) with row stride ldx; with half > 0 a
// panel (m, 2 * half) with leading dimension ldp whose first nb columns of
// each half are filled (the rest NaN: never read).
template <typename T>
static int run(const char* name, int m, int w, int nc, long long ldb, int ob,
               long long ldx, int half = 0, int nb = 0, long long ldp = 0) {
  const T nan = std::numeric_limits<T>::quiet_NaN();
  std::normal_distribution<double> d;
  std::vector<T> bbuf(ob + size_t(m) * ldb + 64, nan);
  T* B = aligned(bbuf, ob);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j)
      B[i * ldb + j] = j <= i ? T(d(rng)) : ((i + j) % 7 ? T(1e6) : nan);
  std::vector<T> xbuf(size_t(m) * ldx + 16, nan);
  T* X = aligned(xbuf, 0);
  for (int i = 0; i < m; ++i)
    for (int c = 0; c < nc; ++c) X[i * ldx + c] = T(d(rng));
  std::vector<T> pbuf(half ? size_t(m) * ldp + 16 : 0, nan);
  T* P = half ? aligned(pbuf, 0) : nullptr;
  for (int i = 0; half && i < m; ++i)
    for (int l = 0; l < nb; ++l)
      for (int part = 0; part < 2; ++part)
        P[i * ldp + part * half + l] = i < w ? T(0) : T(d(rng));
  const int mw = m - w;
  const long long len =
      (half ? 2LL * half : 0) + 2LL * ((mw + 63) / 64) * nc * mw;
  std::vector<T> sbuf(len + 64, T(-3));
  T* S = aligned(sbuf, 0);
  // g = [U^T x ; W^T x] over the window, as the wrapper's torch.mv gives it
  for (int l = 0; l < 2 * half; ++l) {
    T acc = 0;
    const int part = l / half, col = l % half;
    if (col < nb)
      for (int i = w; i < m; ++i)
        acc = std::fma(P[i * ldp + part * half + col], X[i * ldx], acc);
    S[l] = col < nb ? acc : nan;
  }
  const std::vector<T> sbefore(sbuf);
  std::vector<T> qbuf(size_t(m) * nc + 64, T(-5));
  T* Q = aligned(qbuf, 0);

  double amax = 0, xmax = 0, pmax = 0, gmax = 0;
  for (int i = w; i < m; ++i) {
    for (int j = w; j <= i; ++j) amax = std::max(amax, std::fabs(double(B[i * ldb + j])));
    for (int c = 0; c < nc; ++c) xmax = std::max(xmax, std::fabs(double(X[i * ldx + c])));
    for (int l = 0; l < nb; ++l)
      for (int part = 0; part < 2; ++part)
        pmax = std::max(pmax, std::fabs(double(P[i * ldp + part * half + l])));
  }
  for (int l = 0; l < 2 * half; ++l)
    if (l % half < nb) gmax = std::max(gmax, std::fabs(double(S[l])));
  const double c_err = sizeof(T) == 4 ? 1e-5 : 1e-13;
  const double bound =
      c_err * (std::sqrt(double(mw)) * amax * xmax + 2 * nb * pmax * gmax);

  int err = call<T>(m, w, nc, B, ldb, X, ldx, Q, nc, S, len, P, ldp, half, nb);
  std::vector<T> first(Q, Q + size_t(m) * nc);
  err |= call<T>(m, w, nc, B, ldb, X, ldx, Q, nc, S, len, P, ldp, half, nb);
  long wrong = 0, above = 0;
  double worst = 0;
  for (int i = 0; i < m; ++i)
    for (int c = 0; c < nc; ++c) {
      const T got = Q[i * nc + c];
      if (i < w) {
        const T zero = 0;
        if (memcmp(&got, &zero, sizeof(T))) ++above;
        continue;
      }
      long double want = 0;
      for (int j = w; j < m; ++j) {
        const T a = j <= i ? B[i * ldb + j] : B[j * ldb + i];
        want += (long double)a * X[j * ldx + c];
      }
      for (int l = 0; l < nb; ++l) {
        want -= (long double)P[i * ldp + l] * S[half + l];
        want -= (long double)P[i * ldp + half + l] * S[l];
      }
      const double e = std::fabs(double(got - want));
      if (!(e <= bound)) ++wrong;
      if (e > worst || e != e) worst = e;
    }
  const bool repeats =
      !memcmp(first.data(), Q, sizeof(T) * first.size());
  long outside = 0;
  for (size_t e = 0; e < qbuf.size(); ++e) {
    const long long rel = static_cast<long long>(e) - (Q - qbuf.data());
    if ((rel < 0 || rel >= (long long)m * nc) && qbuf[e] != T(-5)) ++outside;
  }
  for (size_t e = (S - sbuf.data()) + len; e < sbuf.size(); ++e)
    if (memcmp(&sbuf[e], &sbefore[e], sizeof(T))) ++outside;
  uint64_t hash = 1469598103934665603ull;
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(Q);
  for (size_t e = 0; e < sizeof(T) * size_t(m) * nc; ++e)
    hash = (hash ^ bytes[e]) * 1099511628211ull;
  printf("%-14s %s m=%d w=%d nc=%d ldb=%lld ob=%d ldx=%lld half=%d nb=%d "
         "err=%d wrong=%ld worst=%.3g bound=%.3g above=%ld outside=%ld "
         "repeats=%d hash=%016llx\n",
         name, sizeof(T) == 4 ? "f32" : "f64", m, w, nc, ldb, ob, ldx, half,
         nb, err, wrong, worst, bound, above, outside, int(repeats),
         (unsigned long long)hash);
  return err || wrong || above || outside || !repeats;
}

template <typename T>
static int cases() {
  int f = 0;
  f |= run<T>("aligned", 200, 0, 1, 200, 0, 1);
  f |= run<T>("window", 300, 64, 1, 300, 0, 1);
  f |= run<T>("window_odd", 301, 37, 1, 301, 0, 1);
  f |= run<T>("odd_ld", 150, 0, 1, 151, 0, 1);
  f |= run<T>("offset_view", 130, 0, 1, 136, 5, 1);
  f |= run<T>("x_strided", 140, 11, 1, 144, 0, 3);
  f |= run<T>("nc3", 140, 7, 3, 140, 0, 5);
  f |= run<T>("nc8", 70, 0, 8, 72, 0, 8);
  f |= run<T>("one_row", 1, 0, 2, 1, 0, 2);
  f |= run<T>("panel", 260, 64, 1, 260, 0, 1, 8, 7, 16);
  f |= run<T>("panel_odd", 201, 3, 1, 203, 1, 1, 5, 5, 11);
  f |= run<T>("panel_empty", 129, 0, 1, 132, 0, 1, 4, 0, 8);
  f |= run<T>("panel_wide", 150, 5, 1, 150, 0, 1, 70, 70, 141);
  return f;
}

int main(int argc, char** argv) {
  const bool f64 = argc > 1 && std::string(argv[1]) == "f64";
  const int f = f64 ? cases<double>() : cases<float>();
  printf(f ? "FAIL\n" : "ALL OK\n");
  return f;
}
