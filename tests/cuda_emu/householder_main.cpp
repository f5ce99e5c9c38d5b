// Runs the kernel of csrc/householder.cu (as rewritten into kern.cpp by the
// test) on CPU threads over the cases of an input file, and writes what
// the entry point returned, for the test to hold against the plain PyTorch
// version.  Arguments: the element type (f32, f64, c64 or c128), the input
// file and the output file.  Input: records of int32 m, int32 p and the m
// elements of x (a complex element as its real and imaginary parts).
// Output: for each record v (m elements), tau (one element) and beta (one
// real).  Each case runs twice, into buffers with a guard past their end:
// the second run must give the first's bits (the fibers resume in another
// order), nothing may be written past v, tau or beta, and x must be left as
// it was.  Prints one line a case and "ALL OK" or "FAIL"; exits non-zero on
// a failure.
#include "kern.cpp"

#include <cstdio>
#include <cstring>
#include <string>
#include <type_traits>
#include <vector>

namespace {

struct Out {
  std::vector<unsigned char> v, tau, beta;
};

constexpr int kGuard = 4;  // elements past each output
constexpr unsigned char kFill = 0x5a;

template <typename T, typename R>
int run(int m, int p, const T* x, Out& out) {
  std::vector<T> v(m + kGuard), tau(1 + kGuard);
  std::vector<R> beta(1 + kGuard);
  memset(v.data(), kFill, v.size() * sizeof(T));
  memset(tau.data(), kFill, tau.size() * sizeof(T));
  memset(beta.data(), kFill, beta.size() * sizeof(R));
  int err;
  if constexpr (std::is_same_v<T, float>)
    err = eigenexa_householder_vector_f32(m, p, x, v.data(), tau.data(),
                                          beta.data(), nullptr);
  else if constexpr (std::is_same_v<T, double>)
    err = eigenexa_householder_vector_f64(m, p, x, v.data(), tau.data(),
                                          beta.data(), nullptr);
  else if constexpr (std::is_same_v<T, float2>)
    err = eigenexa_householder_vector_c64(m, p, x, v.data(), tau.data(),
                                          beta.data(), nullptr);
  else
    err = eigenexa_householder_vector_c128(m, p, x, v.data(), tau.data(),
                                           beta.data(), nullptr);
  if (err != 0) return 1;
  auto guard_kept = [](const void* end, size_t bytes) {
    const unsigned char* c = static_cast<const unsigned char*>(end);
    for (size_t i = 0; i < bytes; ++i)
      if (c[i] != kFill) return false;
    return true;
  };
  if (!guard_kept(v.data() + m, kGuard * sizeof(T)) ||
      !guard_kept(tau.data() + 1, kGuard * sizeof(T)) ||
      !guard_kept(beta.data() + 1, kGuard * sizeof(R)))
    return 2;
  auto bytes = [](const void* p, size_t n) {
    const unsigned char* c = static_cast<const unsigned char*>(p);
    return std::vector<unsigned char>(c, c + n);
  };
  out = {bytes(v.data(), m * sizeof(T)), bytes(tau.data(), sizeof(T)),
         bytes(beta.data(), sizeof(R))};
  return 0;
}

template <typename T, typename R>
bool cases(FILE* in, FILE* out) {
  bool ok = true;
  int32_t head[2];
  while (fread(head, sizeof head, 1, in) == 1) {
    const int m = head[0], p = head[1];
    std::vector<T> x(m);
    if (fread(x.data(), sizeof(T), m, in) != size_t(m)) return false;
    const std::vector<T> keep = x;
    Out first, second;
    const int e1 = run<T, R>(m, p, x.data(), first);
    const int e2 = run<T, R>(m, p, x.data(), second);
    const bool same = e1 == 0 && e2 == 0 && first.v == second.v &&
                      first.tau == second.tau && first.beta == second.beta;
    const bool x_kept = !memcmp(x.data(), keep.data(), m * sizeof(T));
    printf("m=%d p=%d: %s%s%s\n", m, p,
           e1 ? "an output's guard written or a launch refused, " : "",
           same ? "rerun bitwise equal" : "rerun DIFFERS",
           x_kept ? "" : ", x CHANGED");
    ok = ok && same && x_kept;
    fwrite(first.v.data(), 1, first.v.size(), out);
    fwrite(first.tau.data(), 1, first.tau.size(), out);
    fwrite(first.beta.data(), 1, first.beta.size(), out);
  }
  return ok;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s f32|f64|c64|c128 IN OUT\n", argv[0]);
    return 2;
  }
  const std::string type = argv[1];
  FILE* in = fopen(argv[2], "rb");
  FILE* out = fopen(argv[3], "wb");
  if (!in || !out) return 2;
  const bool ok = type == "f32"   ? cases<float, float>(in, out)
                  : type == "f64" ? cases<double, double>(in, out)
                  : type == "c64" ? cases<float2, float>(in, out)
                                  : cases<double2, double>(in, out);
  fclose(in);
  fclose(out);
  puts(ok ? "ALL OK" : "FAIL");
  return ok ? 0 : 1;
}
