// Native chaining hot loops for the nucmer replacement
// (ops/chaining.py): mgaps-style cluster union-find and the delta-filter
// chain DP; ANIm's per-cluster consistent anchor chain lies in band.cpp,
// beside the gap fills it feeds.  Each mirrors its Python reference
// implementation statement-for-statement -- including iteration order,
// strict-inequality tie rules, and float64 arithmetic -- so results are
// bit-identical; the Python versions remain as the no-compiler fallback
// and parity oracle.
//
// Build: g++ -O3 -shared -fPIC chain.cpp -o libchain.so

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

int64_t find_root(std::vector<int64_t> &parent, int64_t x) {
  // path-halving, matching the Python find()
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

}  // namespace

extern "C" {

// mgaps clustering sweep over matches pre-sorted by (r, q): joins each
// match j to the closest compatible earlier match within a 64-wide
// backward window.  Writes each index's final root into roots[n]
// (fully compressed), preserving the Python grouping exactly.
void cluster_roots(const int64_t *r, const int64_t *q, const int64_t *l,
                   int64_t n, int64_t maxgap, int64_t diagdiff,
                   double diagfactor, int64_t *roots) {
  std::vector<int64_t> parent(n);
  for (int64_t i = 0; i < n; i++) parent[i] = i;
  for (int64_t j = 1; j < n; j++) {
    const int64_t dj = q[j] - r[j];
    const int64_t lo = j - 64 > -1 ? j - 64 : -1;
    for (int64_t i = j - 1; i > lo; i--) {
      const int64_t sep = r[j] - (r[i] + l[i]);
      if (sep > maxgap) continue;  // ends are not monotone: keep scanning
      const int64_t di = q[i] - r[i];
      const int64_t sep_q = q[j] - (q[i] + l[i]);
      if (sep_q > maxgap || sep_q < -l[i] || sep < -l[i]) continue;
      const int64_t sep_max = sep > sep_q ? (sep > 0 ? sep : 0)
                                          : (sep_q > 0 ? sep_q : 0);
      const double lim = diagfactor * (double)sep_max;
      const double bound = lim > (double)diagdiff ? lim : (double)diagdiff;
      const int64_t drift = dj > di ? dj - di : di - dj;
      if ((double)drift <= bound) {
        const int64_t pa = find_root(parent, i);
        const int64_t pb = find_root(parent, j);
        if (pa != pb) parent[pb] = pa;
        break;
      }
    }
  }
  for (int64_t i = 0; i < n; i++) roots[i] = find_root(parent, i);
}

// delta-filter LIS (ops/chaining._best_chain): maximum-weight chain
// with starts and ends both non-decreasing.  order[n] is the caller's
// sort by (start, end); writes best[n] (float64 scores) and prev[n]
// (predecessor in the chain, -1 for none).
void chain_dp(const int64_t *starts, const int64_t *ends,
              const double *weights, const int64_t *order, int64_t n,
              double *best, int64_t *prev) {
  for (int64_t oi = 0; oi < n; oi++) {
    const int64_t i = order[oi];
    best[i] = weights[i];
    prev[i] = -1;
    for (int64_t k = 0; k < oi; k++) {
      const int64_t j = order[k];
      if (starts[j] <= starts[i] && ends[j] <= ends[i]) {
        const double cand = best[j] + weights[i];
        if (cand > best[i]) {
          best[i] = cand;
          prev[i] = j;
        }
      }
    }
  }
}

}  // extern "C"
