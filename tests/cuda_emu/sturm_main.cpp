// Runs the kernel of csrc/sturm.cu (as rewritten into kern.cpp by the test)
// on CPU threads and holds every case, bit for bit, against a plain loop
// written from the JAX package's scans (eigenexa_tpu/ops/sturm.py): for
// every index i, n_iter halvings of [a0_i, b0_i] by the Sturm count of the
// midpoint, and with w0 the refinement's valid check.  The plain loop works
// on the raw bands (d, e1[, e2]); the driver packs the kernel's operands
// from them as ops/kernels.py `sturm_setup` does, so a slip in either the
// packing contract or the kernel's recurrence shows.
//
// Cases: band 1 and 2; n from 1 to 600 (several blocks, n rarely a
// multiple of a block's indices, and a chunk of 512 staged twice); random
// bands; integer bands with zero couplings probed at dyadic midpoints, where
// pivots meet 0 exactly and only the pivmin clamps keep the counts finite;
// refinements with brackets that fail; n_iter 1, 2, 7, 45 and 70, most of
// them no multiple of the levels L a round, so the last round is short.
// All of these go through the C entry point (the L of each band); then a
// few cases go through the launch of every L = 1 ... 5, groups of 2 to 32
// lanes.  Prints one line a case and "ALL OK" or "FAIL"; exits non-zero on
// a failure.  An argument runs only the cases whose name holds it (every
// case is still made, so each gets the same bands).
#include "kern.cpp"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

static std::mt19937 rng(7);
static const char* only = nullptr;  // run only cases whose name holds this

// count(x) as the JAX scans compute it, one rounding an operation
static int count_plain(const std::vector<double>& d,
                       const std::vector<double>& e1,
                       const std::vector<double>* e2, double x) {
  const int n = int(d.size());
  if (e2 == nullptr) {
    double pivmin = 1.0;
    for (double e : e1) pivmin = std::max(pivmin, e * e);
    pivmin *= 1e-30;
    double q = 1.0;
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      const double e_sq = k == 0 ? 0.0 : e1[k - 1] * e1[k - 1];
      q = (d[k] - x) - e_sq / q;
      if (std::fabs(q) < pivmin) q = -pivmin;
      cnt += q < 0;
    }
    return cnt;
  }
  auto at = [](const std::vector<double>& v, int k) {
    return k < int(v.size()) ? v[k] : 0.0;
  };
  double dmax = 1.0, e1max = 0.0, e2max = 0.0;
  for (double v : d) dmax = std::max(dmax, std::fabs(v));
  for (double v : e1) e1max = std::max(e1max, std::fabs(v));
  for (double v : *e2) e2max = std::max(e2max, std::fabs(v));
  const double pivmin = ((dmax + e1max) + e2max) * 1e-28;
  double a = d[0] - x, b = at(e1, 0), c = n > 1 ? d[1] - x : 0.0;
  int cnt = 0;
  for (int k = 0; k < n; ++k) {
    const double piv =
        std::fabs(a) < pivmin ? (a >= 0 ? pivmin : -pivmin) : a;
    cnt += piv < 0;
    const double l1 = b / piv, l2 = at(*e2, k) / piv;
    const double a2 = c - l1 * b;
    const double b2 = at(e1, k + 1) - l1 * at(*e2, k);
    c = (at(d, k + 2) - x) - l2 * at(*e2, k);
    a = a2;
    b = b2;
  }
  return cnt;
}

struct Case {
  const char* name;
  std::vector<double> d, e1, e2, a0, b0, w0;
  bool band2, valid;
  int n_iter;
};

// a launch at a given L (levels a round): launch<band2, L> of the source
using Launch = int (*)(int, const double*, const double*, const double*,
                       const double*, const double*, const double*,
                       const double*, int, double*, cudaStream_t);
template <int kL>
Launch at_levels(bool band2) {
  return band2 ? launch<true, kL> : launch<false, kL>;
}

// levels 0: through the C entry point, at the L it picks for the band
static bool run(const Case& c, int levels = 0, Launch at = nullptr) {
  if (only != nullptr && strstr(c.name, only) == nullptr) return true;
  const int n = int(c.d.size());
  const std::vector<double>* e2 = c.band2 ? &c.e2 : nullptr;
  // the kernel's operands, packed as sturm_setup packs them
  std::vector<double> s0(n), s1(n), s2(n, 0.0), head;
  if (!c.band2) {
    double pivmin = 1.0;
    for (int k = 0; k < n; ++k) {
      s0[k] = c.d[k];
      s1[k] = k == 0 ? 0.0 : c.e1[k - 1] * c.e1[k - 1];
      pivmin = std::max(pivmin, s1[k]);
    }
    head = {pivmin * 1e-30};
  } else {
    double dmax = 1.0, e1max = 0.0, e2max = 0.0;
    for (double v : c.d) dmax = std::max(dmax, std::fabs(v));
    for (double v : c.e1) e1max = std::max(e1max, std::fabs(v));
    for (double v : c.e2) e2max = std::max(e2max, std::fabs(v));
    for (int k = 0; k < n; ++k) {
      s0[k] = k + 2 < n ? c.d[k + 2] : 0.0;
      s1[k] = k + 1 < int(c.e1.size()) ? c.e1[k + 1] : 0.0;
      s2[k] = k < int(c.e2.size()) ? c.e2[k] : 0.0;
    }
    head = {((dmax + e1max) + e2max) * 1e-28, c.d[0], n > 1 ? c.d[1] : 0.0,
            c.e1.empty() ? 0.0 : c.e1[0]};
  }
  std::vector<double> w(n + 1, std::nan("")), want(n);
  const double* w0 = c.valid ? c.w0.data() : nullptr;
  const double* p2 = c.band2 ? s2.data() : nullptr;
  const int err =
      levels == 0
          ? eigenexa_sturm_bisect_f64(n, c.band2 ? 2 : 1, s0.data(),
                                      s1.data(), p2, head.data(), c.a0.data(),
                                      c.b0.data(), w0, c.n_iter, w.data(),
                                      nullptr)
          : at(n, s0.data(), s1.data(), p2, head.data(), c.a0.data(),
               c.b0.data(), w0, c.n_iter, w.data(), nullptr);
  int kept = 0;
  for (int i = 0; i < n; ++i) {
    double a = c.a0[i], b = c.b0[i];
    bool ok = true;
    if (c.valid)
      ok = count_plain(c.d, c.e1, e2, a) <= i &&
           count_plain(c.d, c.e1, e2, b) > i;
    for (int it = 0; it < c.n_iter; ++it) {
      const double mid = 0.5 * (a + b);
      if (count_plain(c.d, c.e1, e2, mid) > i)
        b = mid;
      else
        a = mid;
    }
    want[i] = ok ? 0.5 * (a + b) : c.w0[i];
    kept += !ok;
  }
  const bool same = err == 0 && memcmp(w.data(), want.data(), n * 8) == 0 &&
                    std::isnan(w[n]);
  int off = 0;
  for (int i = 0; i < n; ++i)
    off += memcmp(&w[i], &want[i], 8) != 0;
  printf("%-28s n=%3d band %d L %d n_iter %2d valid %d kept_w0 %3d: %s "
         "(%d off)\n",
         c.name, n, c.band2 ? 2 : 1, levels, c.n_iter, c.valid, kept,
         same ? "bitwise equal" : "DIFFERS", off);
  return same;
}

static Case random_case(const char* name, int n, bool band2, bool valid,
                        int n_iter) {
  std::normal_distribution<double> g;
  Case c{name, {}, {}, {}, {}, {}, {}, band2, valid, n_iter};
  for (int k = 0; k < n; ++k) c.d.push_back(g(rng));
  for (int k = 0; k + 1 < n; ++k) c.e1.push_back(g(rng));
  for (int k = 0; k + 2 < n; ++k) c.e2.push_back(band2 ? g(rng) : 0.0);
  double bound = 0.0;
  for (int k = 0; k < n; ++k) bound = std::max(bound, std::fabs(c.d[k]));
  bound += 4.0 * 4.5;  // |e| of N(0, 1) draws stays below 4.5 here
  c.a0.assign(n, -bound);
  c.b0.assign(n, bound);
  if (valid) {
    // w0: a rough bisection (20 steps), every 7th pushed off its index;
    // brackets of half the wider neighbouring gap, as refine_brackets
    const std::vector<double>* e2 = band2 ? &c.e2 : nullptr;
    for (int i = 0; i < n; ++i) {
      double a = -bound, b = bound;
      for (int it = 0; it < 20; ++it) {
        const double mid = 0.5 * (a + b);
        (count_plain(c.d, c.e1, e2, mid) > i ? b : a) = mid;
      }
      c.w0.push_back(0.5 * (a + b) + (i % 7 == 3 ? 3.0 * bound : 0.0));
    }
    for (int i = 0; i < n; ++i) {
      const double left = i > 0 ? std::fabs(c.w0[i] - c.w0[i - 1]) : 1.0;
      const double right =
          i + 1 < n ? std::fabs(c.w0[i + 1] - c.w0[i]) : left;
      const double half = std::max(0.5 * std::max(left, right), 1e-12);
      c.a0[i] = c.w0[i] - half;
      c.b0[i] = c.w0[i] + half;
    }
  }
  return c;
}

// integer diagonal, couplings mostly 0, brackets [-16, 16]: the midpoints
// are dyadic and meet the diagonal entries exactly
static Case exact_zero_case(const char* name, int n, bool band2, bool valid) {
  std::uniform_int_distribution<int> di(-7, 7), pick(0, 5);
  Case c{name, {}, {}, {}, {}, {}, {}, band2, valid, 40};
  for (int k = 0; k < n; ++k) c.d.push_back(di(rng));
  for (int k = 0; k + 1 < n; ++k) c.e1.push_back(pick(rng) == 0 ? 1.0 : 0.0);
  for (int k = 0; k + 2 < n; ++k)
    c.e2.push_back(band2 && pick(rng) == 0 ? 1.0 : 0.0);
  std::vector<double> sorted = c.d;
  std::sort(sorted.begin(), sorted.end());
  for (int i = 0; i < n; ++i) {
    // the sorted diagonal is close to the spectrum: most brackets hold
    // their index, those next to a coupling may not
    c.w0.push_back(sorted[i]);
    c.a0.push_back(valid ? sorted[i] - 0.5 : -16.0);
    c.b0.push_back(valid ? sorted[i] + 0.5 : 16.0);
  }
  return c;
}

int main(int argc, char** argv) {
  if (argc > 1) only = argv[1];
  bool ok = true;
  for (bool band2 : {false, true}) {
    for (int n : {1, 2, 3, 127, 129, 600}) {
      if (band2 && n == 1) continue;
      ok &= run(random_case(band2 ? "random band2" : "random band1", n,
                            band2, false, n > 200 ? 12 : 70));
    }
    ok &= run(random_case(band2 ? "refine band2" : "refine band1", 300,
                          band2, true, 45));
    ok &= run(exact_zero_case(band2 ? "exact zeros band2" : "exact zeros",
                              200, band2, false));
    ok &= run(exact_zero_case(band2 ? "exact zeros refine band2"
                                    : "exact zeros refine", 150, band2,
                              true));
    for (int n_iter : {1, 2, 7, 45, 70})
      for (bool valid : {false, true})
        ok &= run(random_case(band2 ? "n_iter band2" : "n_iter band1",
                              valid ? 77 : 45, band2, valid, n_iter));
  }
  const Launch every_l[][2] = {
      {at_levels<1>(false), at_levels<1>(true)},
      {at_levels<2>(false), at_levels<2>(true)},
      {at_levels<3>(false), at_levels<3>(true)},
      {at_levels<4>(false), at_levels<4>(true)},
      {at_levels<5>(false), at_levels<5>(true)}};
  for (int levels = 1; levels <= 5; ++levels)
    for (bool band2 : {false, true}) {
      const Launch at = every_l[levels - 1][band2];
      ok &= run(random_case(band2 ? "every L band2" : "every L band1", 33,
                            band2, false, 7), levels, at);
      ok &= run(random_case(band2 ? "every L refine band2"
                                  : "every L refine band1", 45, band2, true,
                            70), levels, at);
    }
  printf(ok ? "ALL OK\n" : "FAIL\n");
  return ok ? 0 : 1;
}
