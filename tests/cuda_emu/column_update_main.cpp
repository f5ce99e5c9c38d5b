// Runs the column-update kernels of csrc/householder.cu (as rewritten into
// kern.cpp by the test) on CPU threads over the cases of an input file, and
// writes the panel they left, for the test to hold against the plain
// PyTorch version, the scratch of partial sums NaN until the kernels write
// it.  Arguments: the element type (f32 or f64), the input file and the
// output file.  Input: records of int32 m, c0, j, j0 and ldu, then B.v (m),
// U and W (m rows of ldu each), v (m) and tau (one).  Output: for each
// record U and W as the kernels left them.  Each case runs twice on fresh
// copies of U and W with a guard past their end: the second run must give
// the first's bits (the fibers resume in another order), nothing may be
// written past U or W, and B.v, v and tau must be left as they were.
// Prints one line a case and "ALL OK" or "FAIL"; exits non-zero on a
// failure.
#include "kern.cpp"

#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <type_traits>
#include <vector>

namespace {

constexpr int kGuard = 4;  // elements past U and W
constexpr unsigned char kFill = 0x5a;

template <typename T>
bool same_bits(const std::vector<T>& a, const std::vector<T>& b) {
  return a.size() == b.size() &&
         !memcmp(a.data(), b.data(), a.size() * sizeof(T));
}

template <typename T>
bool guard_kept(const std::vector<T>& a, size_t n) {
  const unsigned char* c =
      reinterpret_cast<const unsigned char*>(a.data() + n);
  for (size_t i = 0; i < kGuard * sizeof(T); ++i)
    if (c[i] != kFill) return false;
  return true;
}

template <typename T>
int run(int m, int c0, int j, int j0, int ldu, const std::vector<T>& bv,
        const std::vector<T>& u0, const std::vector<T>& w0,
        const std::vector<T>& v, const std::vector<T>& tau,
        std::vector<T>& u, std::vector<T>& w) {
  const size_t n = size_t(m) * ldu;
  u.assign(n + kGuard, T(0));
  w.assign(n + kGuard, T(0));
  memset(u.data() + n, kFill, kGuard * sizeof(T));
  memset(w.data() + n, kFill, kGuard * sizeof(T));
  memcpy(u.data(), u0.data(), n * sizeof(T));
  memcpy(w.data(), w0.data(), n * sizeof(T));
  // the slabs' partial sums: NaN until the kernels write them
  std::vector<T> scratch(64 * (2 * size_t(c0) + 1),
                         std::numeric_limits<T>::quiet_NaN());
  int err;
  if constexpr (std::is_same_v<T, float>)
    err = eigenexa_column_update_f32(m, c0, j, j0, bv.data(), u.data(),
                                     w.data(), ldu, v.data(), tau.data(),
                                     scratch.data(), nullptr);
  else
    err = eigenexa_column_update_f64(m, c0, j, j0, bv.data(), u.data(),
                                     w.data(), ldu, v.data(), tau.data(),
                                     scratch.data(), nullptr);
  if (err != 0) return 1;
  if (!guard_kept(u, n) || !guard_kept(w, n)) return 2;
  u.resize(n);
  w.resize(n);
  return 0;
}

template <typename T>
bool read(FILE* in, std::vector<T>& x, size_t n) {
  x.resize(n);
  return fread(x.data(), sizeof(T), n, in) == n;
}

template <typename T>
bool cases(FILE* in, FILE* out) {
  bool ok = true;
  int32_t head[5];
  while (fread(head, sizeof head, 1, in) == 1) {
    const int m = head[0], c0 = head[1], j = head[2], j0 = head[3],
              ldu = head[4];
    std::vector<T> bv, u0, w0, v, tau;
    if (!read(in, bv, size_t(m)) || !read(in, u0, size_t(m) * ldu) ||
        !read(in, w0, size_t(m) * ldu) || !read(in, v, size_t(m)) ||
        !read(in, tau, 1))
      return false;
    const std::vector<T> keep_bv = bv, keep_v = v, keep_tau = tau;
    std::vector<T> u1, w1, u2, w2;
    const int e1 = run<T>(m, c0, j, j0, ldu, bv, u0, w0, v, tau, u1, w1);
    const int e2 = run<T>(m, c0, j, j0, ldu, bv, u0, w0, v, tau, u2, w2);
    const bool same =
        e1 == 0 && e2 == 0 && same_bits(u1, u2) && same_bits(w1, w2);
    const bool kept = same_bits(bv, keep_bv) && same_bits(v, keep_v) &&
                      same_bits(tau, keep_tau);
    printf("m=%d c0=%d j=%d j0=%d ldu=%d: %s%s%s\n", m, c0, j, j0, ldu,
           e1 ? "a guard written or a launch refused, " : "",
           same ? "rerun bitwise equal" : "rerun DIFFERS",
           kept ? "" : ", an input CHANGED");
    ok = ok && same && kept;
    if (e1) {
      u1.assign(size_t(m) * ldu, T(0));
      w1.assign(size_t(m) * ldu, T(0));
    }
    fwrite(u1.data(), sizeof(T), u1.size(), out);
    fwrite(w1.data(), sizeof(T), w1.size(), out);
  }
  return ok;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s f32|f64 IN OUT\n", argv[0]);
    return 2;
  }
  const std::string type = argv[1];
  FILE* in = fopen(argv[2], "rb");
  FILE* out = fopen(argv[3], "wb");
  if (!in || !out) return 2;
  const bool ok = type == "f32" ? cases<float>(in, out)
                                : cases<double>(in, out);
  fclose(in);
  fclose(out);
  puts(ok ? "ALL OK" : "FAIL");
  return ok ? 0 : 1;
}
