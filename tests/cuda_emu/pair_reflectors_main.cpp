// Runs the reflector-pair kernel of csrc/householder.cu (as rewritten into
// kern.cpp by the test) on CPU threads over the cases of an input file, and
// writes what the entry point returned, for the test to hold against the
// plain PyTorch version.  Arguments: the element type (f32 or f64), the
// input file and the output file.  Input: records of int32 m, int32 p,
// int32 ldx and the m rows of x, ldx elements each (the pair's two columns
// first, the rest of a row padding).  Output: for each record V (m rows of
// two), tau (two elements) and T (four, by rows).  Each case runs twice,
// into buffers with a guard past their end and V's rows three elements
// apart: the second run must give the first's bits (the fibers resume in
// another order), nothing may be written outside V's two columns, tau or T,
// and x must be left as it was.  Prints one line a case and "ALL OK" or
// "FAIL"; exits non-zero on a failure.
#include "kern.cpp"

#include <cstdio>
#include <cstring>
#include <string>
#include <type_traits>
#include <vector>

namespace {

constexpr int kGuard = 4;  // elements past each output
constexpr int kLdv = 3;    // V's row stride: one element of padding a row
constexpr unsigned char kFill = 0x5a;

template <typename T>
struct Out {
  std::vector<T> v, tau, t;
};

template <typename T>
bool filled(const T* p, size_t n) {
  const unsigned char* c = reinterpret_cast<const unsigned char*>(p);
  for (size_t i = 0; i < n * sizeof(T); ++i)
    if (c[i] != kFill) return false;
  return true;
}

template <typename T>
int run(int m, int p, int ldx, const T* x, Out<T>& out) {
  std::vector<T> v(size_t(m) * kLdv + kGuard), tau(2 + kGuard),
      t(4 + kGuard);
  memset(v.data(), kFill, v.size() * sizeof(T));
  memset(tau.data(), kFill, tau.size() * sizeof(T));
  memset(t.data(), kFill, t.size() * sizeof(T));
  int err;
  if constexpr (std::is_same_v<T, float>)
    err = eigenexa_pair_reflectors_f32(m, p, x, ldx, v.data(), kLdv,
                                       tau.data(), t.data(), nullptr);
  else
    err = eigenexa_pair_reflectors_f64(m, p, x, ldx, v.data(), kLdv,
                                       tau.data(), t.data(), nullptr);
  if (err != 0) return 1;
  for (int i = 0; i < m; ++i)
    if (!filled(v.data() + size_t(i) * kLdv + 2, 1)) return 2;
  if (!filled(v.data() + size_t(m) * kLdv, kGuard) ||
      !filled(tau.data() + 2, kGuard) || !filled(t.data() + 4, kGuard))
    return 2;
  out.v.clear();
  for (int i = 0; i < m; ++i) {
    out.v.push_back(v[size_t(i) * kLdv]);
    out.v.push_back(v[size_t(i) * kLdv + 1]);
  }
  out.tau.assign(tau.begin(), tau.begin() + 2);
  out.t.assign(t.begin(), t.begin() + 4);
  return 0;
}

template <typename T>
bool same_bits(const std::vector<T>& a, const std::vector<T>& b) {
  return a.size() == b.size() &&
         !memcmp(a.data(), b.data(), a.size() * sizeof(T));
}

template <typename T>
bool cases(FILE* in, FILE* out) {
  bool ok = true;
  int32_t head[3];
  while (fread(head, sizeof head, 1, in) == 1) {
    const int m = head[0], p = head[1], ldx = head[2];
    std::vector<T> x(size_t(m) * ldx);
    if (fread(x.data(), sizeof(T), x.size(), in) != x.size()) return false;
    const std::vector<T> keep = x;
    Out<T> first, second;
    const int e1 = run<T>(m, p, ldx, x.data(), first);
    const int e2 = run<T>(m, p, ldx, x.data(), second);
    const bool same = e1 == 0 && e2 == 0 && same_bits(first.v, second.v) &&
                      same_bits(first.tau, second.tau) &&
                      same_bits(first.t, second.t);
    const bool x_kept = same_bits(x, keep);
    printf("m=%d p=%d ldx=%d: %s%s%s\n", m, p, ldx,
           e1 ? "an output's guard written or a launch refused, " : "",
           same ? "rerun bitwise equal" : "rerun DIFFERS",
           x_kept ? "" : ", x CHANGED");
    ok = ok && same && x_kept;
    if (e1) first = {std::vector<T>(2 * size_t(m)), std::vector<T>(2),
                     std::vector<T>(4)};
    fwrite(first.v.data(), sizeof(T), first.v.size(), out);
    fwrite(first.tau.data(), sizeof(T), 2, out);
    fwrite(first.t.data(), sizeof(T), 4, out);
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
