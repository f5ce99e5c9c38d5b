// Runs the kernels of csrc/sub_matmul.cu (as rewritten into kern.cpp by the
// test) on CPU threads and holds every output bit for bit against the
// contract: one chain of fma over k in ascending order from 0, then b - acc;
// nothing outside the view or the window written.  The argument picks the
// element type, f32 (the default) or f64.  Prints one line a case and
// "ALL OK" or "FAIL"; exits non-zero on a failure.
#include "kern.cpp"

#include <cstdio>
#include <cstring>
#include <random>
#include <string>

static std::mt19937 rng(7);

template <typename T>
static void fill(std::vector<T>& v) {
  std::normal_distribution<T> d;
  for (auto& x : v) x = d(rng);
}

template <typename T>
static T* aligned(std::vector<T>& v, int offset) {
  return reinterpret_cast<T*>(
             (reinterpret_cast<uintptr_t>(v.data()) + 15) & ~uintptr_t(15)) +
         offset;
}

template <typename T>
static void call(int m, int n, int k, T* B, long long ldb, const T* P,
                 const T* Q, long long ldp, T* O, long long ldo, int win) {
  if constexpr (sizeof(T) == 4) {
    if (win >= 0)
      eigenexa_sub_matmul_window_f32(m, win, k, B, ldb, P, ldp, Q, ldp,
                                     nullptr);
    else
      eigenexa_sub_matmul_f32(m, n, k, B, ldb, P, ldp, Q, ldp, O, ldo,
                              nullptr);
  } else {
    if (win >= 0)
      eigenexa_sub_matmul_window_f64(m, win, k, B, ldb, P, ldp, Q, ldp,
                                     nullptr);
    else
      eigenexa_sub_matmul_f64(m, n, k, B, ldb, P, ldp, Q, ldp, O, ldo,
                              nullptr);
  }
}

// B is an (m, n) view with leading dimension ldb, `ob` elements past a
// 16-byte boundary; P and Q have leading dimension ldp and start `op`
// elements past one.  win >= 0 takes the window entry point (m == n), else
// the plain one, in place or into a fresh contiguous output.
template <typename T>
static int run(const char* name, int m, int n, int k, long long ldb, int ob,
               long long ldp, int op, bool inplace, int win = -1) {
  std::vector<T> bbuf(ob + size_t(m) * ldb + 64),
      pbuf(op + size_t(m) * ldp + 64), qbuf(op + size_t(n) * ldp + 64),
      obuf(size_t(m) * n + 64, T(-7));
  fill(bbuf);
  fill(pbuf);
  fill(qbuf);
  T* B = aligned(bbuf, ob);
  T* P = aligned(pbuf, op);
  T* Q = aligned(qbuf, op);
  T* O = aligned(obuf, 0);
  const std::vector<T> before(bbuf);
  const long long origin = B - bbuf.data();
  const int w = win < 0 ? 0 : win;
  std::vector<T> ref(size_t(m) * n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      T acc = 0;
      for (int l = 0; l < k; ++l)
        acc = std::fma(P[i * ldp + l], Q[j * ldp + l], acc);
      ref[size_t(i) * n + j] = B[i * ldb + j] - acc;
    }
  call<T>(m, n, k, B, ldb, P, Q, ldp, inplace ? B : O, inplace ? ldb : n,
          win);
  long bad = 0, outside = 0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      const T got =
          (inplace || win >= 0) ? B[i * ldb + j] : O[size_t(i) * n + j];
      const T want = (win >= 0 && (i < w || j < w))
                         ? before[origin + i * ldb + j]
                         : ref[size_t(i) * n + j];
      if (memcmp(&got, &want, sizeof(T))) ++bad;
    }
  for (size_t e = 0; e < bbuf.size(); ++e) {
    const long long rel = static_cast<long long>(e) - origin;
    const bool inside = rel >= 0 && rel / ldb < m && rel % ldb < n;
    if (!inside && memcmp(&bbuf[e], &before[e], sizeof(T))) ++outside;
  }
  printf("%-16s %s m=%d n=%d k=%d ldb=%lld ob=%d ldp=%lld op=%d inplace=%d "
         "win=%d wrong=%ld outside=%ld\n", name, sizeof(T) == 4 ? "f32" : "f64",
         m, n, k, ldb, ob, ldp, op, inplace, win, bad, outside);
  return bad || outside;
}

static int f32_cases() {
  int f = 0;
  f |= run<float>("aligned", 256, 256, 128, 256, 0, 128, 0, false);
  f |= run<float>("aligned_inplace", 256, 384, 128, 400, 0, 128, 0, true);
  f |= run<float>("ragged", 200, 150, 21, 150, 0, 21, 0, false);
  f |= run<float>("ragged_ld4", 203, 157, 100, 160, 0, 100, 0, true);
  f |= run<float>("odd_ld", 300, 257, 128, 261, 0, 128, 0, true);
  f |= run<float>("offset_view", 263, 263, 128, 300, 37, 128, 0, true);
  f |= run<float>("k5", 256, 256, 5, 256, 0, 5, 0, false);
  f |= run<float>("k132", 256, 256, 132, 256, 0, 132, 0, false);
  f |= run<float>("k130_of_132", 256, 260, 130, 260, 0, 132, 0, true);
  f |= run<float>("k0", 256, 256, 0, 256, 0, 4, 0, false);
  f |= run<float>("k3", 130, 260, 3, 260, 0, 4, 0, true);
  f |= run<float>("k16", 129, 257, 16, 260, 0, 16, 0, true);
  f |= run<float>("k17_p_offset", 129, 257, 17, 260, 0, 20, 1, true);
  f |= run<float>("window", 300, 300, 128, 300, 0, 128, 0, false, 40);
  f |= run<float>("window_odd", 301, 301, 24, 301, 0, 24, 0, false, 37);
  f |= run<float>("one_tile", 100, 100, 64, 100, 0, 64, 0, false);
  return f;
}

// The DMMA kernel's edges: a ragged edge in both directions, an odd leading
// dimension and an offset view (no 16-byte access to B), k = 0, odd k and k
// one past a K-slice, P one element past a 16-byte boundary, windows.
static int f64_cases() {
  int f = 0;
  f |= run<double>("aligned", 256, 128, 32, 128, 0, 32, 0, false);
  f |= run<double>("aligned_inplace", 128, 192, 24, 200, 0, 24, 0, true);
  f |= run<double>("ragged", 150, 100, 21, 100, 0, 21, 0, false);
  f |= run<double>("odd_ld", 100, 67, 16, 71, 0, 16, 0, true);
  f |= run<double>("offset_view", 100, 70, 12, 80, 37, 12, 0, true);
  f |= run<double>("k0", 128, 64, 0, 64, 0, 4, 0, false);
  f |= run<double>("k3", 100, 65, 3, 66, 0, 4, 0, true);
  f |= run<double>("k9_p_offset", 100, 100, 9, 102, 0, 10, 1, true);
  f |= run<double>("window", 150, 150, 16, 150, 0, 16, 0, false, 40);
  f |= run<double>("window_odd", 131, 131, 13, 131, 0, 13, 0, false, 37);
  return f;
}

int main(int argc, char** argv) {
  const bool f64 = argc > 1 && std::string(argv[1]) == "f64";
  const int f = f64 ? f64_cases() : f32_cases();
  printf(f ? "FAIL\n" : "ALL OK\n");
  return f;
}
