// Runs the kernels of csrc/sub_matmul.cu (as rewritten into kern.cpp by the
// test) on CPU threads and holds every output bit for bit against the
// contract: one chain of fmaf over k in ascending order from 0, then b - acc;
// nothing outside the view or the window written.  Prints one line a case and
// "ALL OK" or "FAIL"; exits non-zero on a failure.
#include "kern.cpp"

#include <cstdio>
#include <cstring>
#include <random>

static std::mt19937 rng(7);

static void fill(std::vector<float>& v) {
  std::normal_distribution<float> d;
  for (auto& x : v) x = d(rng);
}

static float* aligned(std::vector<float>& v, int offset) {
  return reinterpret_cast<float*>(
             (reinterpret_cast<uintptr_t>(v.data()) + 15) & ~uintptr_t(15)) +
         offset;
}

// B is an (m, n) view with leading dimension ldb, `ob` floats past a 16-byte
// boundary; P and Q have leading dimension ldp and start `op` floats past
// one.  win >= 0 takes the window entry point (m == n), else the plain one,
// in place or into a fresh contiguous output.
static int run(const char* name, int m, int n, int k, long long ldb, int ob,
               long long ldp, int op, bool inplace, int win = -1) {
  std::vector<float> bbuf(ob + size_t(m) * ldb + 64),
      pbuf(op + size_t(m) * ldp + 64), qbuf(op + size_t(n) * ldp + 64),
      obuf(size_t(m) * n + 64, -7.f);
  fill(bbuf);
  fill(pbuf);
  fill(qbuf);
  float* B = aligned(bbuf, ob);
  float* P = aligned(pbuf, op);
  float* Q = aligned(qbuf, op);
  float* O = aligned(obuf, 0);
  const std::vector<float> before(bbuf);
  const long long origin = B - bbuf.data();
  const int w = win < 0 ? 0 : win;
  std::vector<float> ref(size_t(m) * n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      float acc = 0.f;
      for (int l = 0; l < k; ++l)
        acc = fmaf(P[i * ldp + l], Q[j * ldp + l], acc);
      ref[size_t(i) * n + j] = B[i * ldb + j] - acc;
    }
  if (win >= 0)
    eigenexa_sub_matmul_window_f32(m, w, k, B, ldb, P, ldp, Q, ldp, nullptr);
  else
    eigenexa_sub_matmul_f32(m, n, k, B, ldb, P, ldp, Q, ldp,
                            inplace ? B : O, inplace ? ldb : n, nullptr);
  long bad = 0, outside = 0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      const float got =
          (inplace || win >= 0) ? B[i * ldb + j] : O[size_t(i) * n + j];
      const float want = (win >= 0 && (i < w || j < w))
                             ? before[origin + i * ldb + j]
                             : ref[size_t(i) * n + j];
      if (memcmp(&got, &want, 4)) ++bad;
    }
  for (size_t e = 0; e < bbuf.size(); ++e) {
    const long long rel = static_cast<long long>(e) - origin;
    const bool inside = rel >= 0 && rel / ldb < m && rel % ldb < n;
    if (!inside && memcmp(&bbuf[e], &before[e], 4)) ++outside;
  }
  printf("%-16s m=%d n=%d k=%d ldb=%lld ob=%d ldp=%lld op=%d inplace=%d "
         "win=%d wrong=%ld outside=%ld\n", name, m, n, k, ldb, ob, ldp, op,
         inplace, win, bad, outside);
  return bad || outside;
}

int main() {
  int f = 0;
  f |= run("aligned", 256, 256, 128, 256, 0, 128, 0, false);
  f |= run("aligned_inplace", 256, 384, 128, 400, 0, 128, 0, true);
  f |= run("ragged", 200, 150, 21, 150, 0, 21, 0, false);
  f |= run("ragged_ld4", 203, 157, 100, 160, 0, 100, 0, true);
  f |= run("odd_ld", 300, 257, 128, 261, 0, 128, 0, true);
  f |= run("offset_view", 263, 263, 128, 300, 37, 128, 0, true);
  f |= run("k5", 256, 256, 5, 256, 0, 5, 0, false);
  f |= run("k132", 256, 256, 132, 256, 0, 132, 0, false);
  f |= run("k130_of_132", 256, 260, 130, 260, 0, 132, 0, true);
  f |= run("k0", 256, 256, 0, 256, 0, 4, 0, false);
  f |= run("k3", 130, 260, 3, 260, 0, 4, 0, true);
  f |= run("k16", 129, 257, 16, 260, 0, 16, 0, true);
  f |= run("k17_p_offset", 129, 257, 17, 260, 0, 20, 1, true);
  f |= run("window", 300, 300, 128, 300, 0, 128, 0, false, 40);
  f |= run("window_odd", 301, 301, 24, 301, 0, 24, 0, false, 37);
  f |= run("one_tile", 100, 100, 64, 100, 0, 64, 0, false);
  printf(f ? "FAIL\n" : "ALL OK\n");
  return f;
}
