// Seed hash-join + fused-key sort for the ANIb candidate sweep.
//
// Replaces the numpy hash join (searchsorted + repeat + gather) whose
// temporaries dominated the per-pair profile at tens of millions of
// hits.  Both sides arrive ascending-sorted, so the join is a linear
// MERGE (sequential memory; per-query binary search thrashed the cache
// at 4M lookups into a 40 MB table).  Each hit emits one fused key
//
//   key = (frag_id << 34) + (table_pos - within + bias)
//
// with bias chosen by the caller so the low field is non-negative and
// < 2^34 (subject positions < 16 Gb).  Sorting the keys groups hits by
// fragment with diagonals ascending inside each group -- exactly the
// layout the band clustering consumes.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// Advance past the run of equal values starting at i.
inline int64_t run_end(const int64_t *v, int64_t n, int64_t i) {
  const int64_t x = v[i];
  while (i < n && v[i] == x) i++;
  return i;
}

}  // namespace

extern "C" {

// Total number of join hits; both arrays ascending-sorted.
int64_t seed_join_count_sorted(const int64_t *tv, int64_t tn,
                               const int64_t *qv, int64_t qn) {
  int64_t total = 0, i = 0, j = 0;
  while (i < tn && j < qn) {
    if (tv[i] < qv[j]) {
      i++;
    } else if (tv[i] > qv[j]) {
      j++;
    } else {
      const int64_t i2 = run_end(tv, tn, i);
      const int64_t j2 = run_end(qv, qn, j);
      total += (i2 - i) * (j2 - j);
      i = i2;
      j = j2;
    }
  }
  return total;
}

// Join and bucket by fragment: out receives every hit's diagonal
// (table_pos - q_within), grouped by fragment in ascending fragment
// order and sorted ascending inside each fragment's slice; frag_counts
// (size n_frags) receives each fragment's hit count.  qv/q_within/
// q_frag are parallel arrays sorted by qv; q_frag values lie in
// [0, n_frags). Returns the count written, or -1 if cap is too small
// (size cap with seed_join_count_sorted).
//
// Two merge passes (count per fragment, then emit straight into each
// fragment's slice) plus ~12k-element per-bucket sorts replace one
// global std::sort of tens of millions of keys -- fewer comparisons,
// L2-resident runs, and no 100M-element numpy post-processing.
int64_t seed_join_diags_sorted(const int64_t *tv, const int64_t *tp, int64_t tn,
                               const int64_t *qv, const int64_t *q_within,
                               const int64_t *q_frag, int64_t qn,
                               int64_t n_frags, int64_t *frag_counts,
                               int64_t *out, int64_t cap) {
  for (int64_t f = 0; f < n_frags; f++) frag_counts[f] = 0;
  int64_t total = 0, i = 0, j = 0;
  while (i < tn && j < qn) {
    if (tv[i] < qv[j]) {
      i++;
    } else if (tv[i] > qv[j]) {
      j++;
    } else {
      const int64_t i2 = run_end(tv, tn, i);
      const int64_t j2 = run_end(qv, qn, j);
      const int64_t t_run = i2 - i;
      for (int64_t jj = j; jj < j2; jj++) frag_counts[q_frag[jj]] += t_run;
      total += t_run * (j2 - j);
      i = i2;
      j = j2;
    }
  }
  if (total > cap) return -1;
  std::vector<int64_t> offsets(n_frags + 1, 0);
  for (int64_t f = 0; f < n_frags; f++)
    offsets[f + 1] = offsets[f] + frag_counts[f];
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  i = 0;
  j = 0;
  while (i < tn && j < qn) {
    if (tv[i] < qv[j]) {
      i++;
    } else if (tv[i] > qv[j]) {
      j++;
    } else {
      const int64_t i2 = run_end(tv, tn, i);
      const int64_t j2 = run_end(qv, qn, j);
      for (int64_t jj = j; jj < j2; jj++) {
        const int64_t w = q_within[jj];
        int64_t &c = cursor[q_frag[jj]];
        for (int64_t ii = i; ii < i2; ii++) out[c++] = tp[ii] - w;
      }
      i = i2;
      j = j2;
    }
  }
  for (int64_t f = 0; f < n_frags; f++)
    std::sort(out + offsets[f], out + offsets[f + 1]);
  return total;
}

}  // extern "C"

extern "C" {

// Stable in-place sort of parallel query rows (v, w, f) by v, used by
// the ANIb candidate sweep before the merge join.  Seed values are
// 2-bit-packed 11-mers (< 2^22), so two 11-bit counting passes beat a
// comparison argsort several-fold and run with the GIL released; any
// wider value falls back to a stable comparison sort on indices.
void seed_sort_rows(int64_t *v, int64_t *w, int64_t *f, int64_t n) {
  if (n <= 1) return;
  bool small = true;
  for (int64_t i = 0; i < n; i++)
    if ((uint64_t)v[i] >= (1ull << 22)) { small = false; break; }
  std::vector<int64_t> perm(n), tmp(n);
  for (int64_t i = 0; i < n; i++) perm[i] = i;
  if (small) {
    constexpr int B = 11;
    constexpr int64_t M = (1 << B) - 1;
    int64_t hist[1 << B];
    for (int shift = 0; shift <= B; shift += B) {
      std::fill(hist, hist + (1 << B), 0);
      for (int64_t i = 0; i < n; i++) hist[(v[perm[i]] >> shift) & M]++;
      int64_t sum = 0;
      for (int64_t b = 0; b < (1 << B); b++) {
        const int64_t c = hist[b];
        hist[b] = sum;
        sum += c;
      }
      for (int64_t i = 0; i < n; i++)
        tmp[hist[(v[perm[i]] >> shift) & M]++] = perm[i];
      perm.swap(tmp);
    }
  } else {
    std::stable_sort(perm.begin(), perm.end(),
                     [&](int64_t a, int64_t b) { return v[a] < v[b]; });
  }
  // apply the permutation to all three arrays via one gather each
  for (int64_t i = 0; i < n; i++) tmp[i] = v[perm[i]];
  std::copy(tmp.begin(), tmp.end(), v);
  for (int64_t i = 0; i < n; i++) tmp[i] = w[perm[i]];
  std::copy(tmp.begin(), tmp.end(), w);
  for (int64_t i = 0; i < n; i++) tmp[i] = f[perm[i]];
  std::copy(tmp.begin(), tmp.end(), f);
}

}  // extern "C"
