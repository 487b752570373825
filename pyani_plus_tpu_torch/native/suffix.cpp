// Native suffix array + Kasai LCP (host hot path for bacterial-scale
// ANIm/dnadiff seeding).
//
// Suffix array via SA-IS (Nong, Zhang & Chan 2009): linear-time induced
// sorting of LMS substrings with recursion on the reduced problem.
// Input symbols are first remapped to dense ranks (the callers use
// arbitrary int64 symbols: nucleotide codes, separators, and unique
// per-N sentinels), then a unique smallest sentinel 0 is appended.
// Output equals any correct suffix array (suffix order is unique) --
// parity-tested against the numpy prefix-doubling implementation and a
// brute-force oracle.
//
// Kasai's O(n) LCP walk is a scalar loop ~100x faster here than in
// Python.
//
// Build: g++ -O3 -shared -fPIC suffix.cpp -o libsuffix.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <vector>

extern "C" {

// text: int64 symbols, sa: int64 suffix array; writes lcp[n] where
// lcp[r] = LCP(suffix sa[r-1], suffix sa[r]), lcp[0] = 0.
void kasai_lcp(const int64_t *text, const int64_t *sa, int64_t n,
               int64_t *lcp) {
  if (n == 0) return;
  std::vector<int64_t> rank(n);
  for (int64_t r = 0; r < n; r++) rank[sa[r]] = r;
  int64_t h = 0;
  lcp[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t r = rank[i];
    if (r > 0) {
      const int64_t j = sa[r - 1];
      const int64_t max_h = n - (i > j ? i : j);
      while (h < max_h && text[i + h] == text[j + h]) h++;
      lcp[r] = h;
      if (h > 0) h--;
    } else {
      h = 0;
    }
  }
}

namespace sais_impl {

inline bool is_lms(const std::vector<uint8_t> &t, int64_t i) {
  return i > 0 && t[i] && !t[i - 1];
}

static void get_buckets(const int64_t *T, int64_t n, int64_t K,
                        std::vector<int64_t> &bkt, bool end) {
  std::fill(bkt.begin(), bkt.end(), 0);
  for (int64_t i = 0; i < n; i++) bkt[T[i]]++;
  int64_t sum = 0;
  for (int64_t k = 0; k < K; k++) {
    sum += bkt[k];
    bkt[k] = end ? sum : sum - bkt[k];
  }
}

static void induce(const int64_t *T, int64_t *SA, int64_t n, int64_t K,
                   const std::vector<uint8_t> &t, std::vector<int64_t> &bkt) {
  // induce L-type from sorted LMS/S positions
  get_buckets(T, n, K, bkt, false);
  for (int64_t i = 0; i < n; i++) {
    const int64_t j = SA[i] - 1;
    if (SA[i] > 0 && !t[j]) SA[bkt[T[j]]++] = j;
  }
  // induce S-type
  get_buckets(T, n, K, bkt, true);
  for (int64_t i = n - 1; i >= 0; i--) {
    const int64_t j = SA[i] - 1;
    if (SA[i] > 0 && t[j]) SA[--bkt[T[j]]] = j;
  }
}

// T[0..n): symbols in [0, K), T[n-1] = 0 the unique smallest sentinel.
static void sais(const int64_t *T, int64_t *SA, int64_t n, int64_t K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  std::vector<uint8_t> t(n);
  t[n - 1] = true;
  for (int64_t i = n - 2; i >= 0; i--)
    t[i] = T[i] < T[i + 1] || (T[i] == T[i + 1] && t[i + 1]);
  std::vector<int64_t> bkt(K);

  // Stage 1: sort LMS substrings by induced sorting
  std::fill(SA, SA + n, (int64_t)-1);
  get_buckets(T, n, K, bkt, true);
  for (int64_t i = 1; i < n; i++)
    if (is_lms(t, i)) SA[--bkt[T[i]]] = i;
  induce(T, SA, n, K, t, bkt);

  // Compact the sorted LMS positions into SA[0..n1)
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; i++)
    if (is_lms(t, SA[i])) SA[n1++] = SA[i];

  // Name LMS substrings into SA[n1..n)
  std::fill(SA + n1, SA + n, (int64_t)-1);
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; i++) {
    const int64_t pos = SA[i];
    bool diff = false;
    if (prev == -1) {
      diff = true;
    } else {
      for (int64_t d = 0;; d++) {
        if (pos + d == n || prev + d == n || T[pos + d] != T[prev + d] ||
            t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(t, pos + d) || is_lms(t, prev + d))) break;
      }
    }
    if (diff) {
      name++;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }
  for (int64_t i = n - 1, j = n - 1; i >= n1; i--)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // Stage 2: sort the reduced problem
  int64_t *SA1 = SA;
  int64_t *s1 = SA + n - n1;
  if (name < n1) {
    sais(s1, SA1, n1, name);
  } else {
    for (int64_t i = 0; i < n1; i++) SA1[s1[i]] = i;
  }

  // Stage 3: induce the full SA from the sorted LMS suffixes
  for (int64_t i = 1, j = 0; i < n; i++)
    if (is_lms(t, i)) s1[j++] = i;  // LMS positions in text order
  for (int64_t i = 0; i < n1; i++) SA1[i] = s1[SA1[i]];
  std::fill(SA + n1, SA + n, (int64_t)-1);
  get_buckets(T, n, K, bkt, true);
  for (int64_t i = n1 - 1; i >= 0; i--) {
    const int64_t j = SA[i];
    SA[i] = -1;
    SA[--bkt[T[j]]] = j;
  }
  induce(T, SA, n, K, t, bkt);
}

}  // namespace sais_impl

// ---------------------------------------------------------------------
// Suffix automaton over the REVERSED reference: a reusable per-subject
// index for MUM seeding (ops/suffix.py mum_matches_indexed).
//
// Building over rev(ref) makes "longest suffix of the processed stream"
// equal "longest prefix of qry[j:] present in ref" when the query is
// streamed right-to-left, which is exactly the per-start matching
// statistic ms[j] that MUM enumeration needs: at most one MUM can start
// at each query position, and it must have length ms[j] (any shorter
// right-maximal match at the unique ref occurrence would contradict
// uniqueness).  Ambiguous bases (code >= 4) share one non-query symbol;
// that never changes occurrence counts of pure-ACGT strings.
//
// Per state: len/link/firstpos/cnt int32 + 5 transitions.
// cnt = |endpos| (occurrences in ref); firstpos = end of the first
// occurrence in the reversed text (exact when cnt == 1: clones always
// carry cnt >= 2, so uniqueness only triggers on primary states).

namespace sam_impl {

constexpr int SIGMA = 5;

// Hot per-state fields live in one 32-byte block (stride 8 int32:
// len, link, next[SIGMA], cnt) so the build/stream link walks touch a
// single cache line per state; fpos/clone are cold side arrays.
constexpr int STRIDE = 8;
constexpr int F_LEN = 0;
constexpr int F_LINK = 1;
constexpr int F_NXT = 2;  // .. F_NXT + SIGMA
constexpr int F_CNT = 7;

// sam_stream_ms_lanes: one lane a MS_LANE_MIN query bases, at most
// MS_LANES_MAX lanes (misses in flight a thread).
constexpr int MS_LANES_MAX = 16;
constexpr int64_t MS_LANE_MIN = 1 << 14;

struct Sam {
  int64_t n = 0;  // text length (forward)
  std::vector<int32_t> hot;  // STRIDE per state
  std::vector<int32_t> fpos;
  std::vector<uint8_t> clone;
  int64_t states = 0;
  // Lazy maxmatch support: Euler tour of the suffix-link tree.
  // endpos(v) = { fpos of non-clone states in v's link subtree } =
  // pos_list[tour_lo[v] : tour_hi[v]); a child's range is a contiguous
  // sub-range of its parent's, so endpos(v) \ endpos(child) is two
  // contiguous spans -- O(1) per emitted occurrence.
  std::vector<int32_t> tour_lo, tour_hi, pos_list;

  int32_t add_state(int32_t l) {
    const size_t base = hot.size();
    hot.resize(base + STRIDE, -1);
    hot[base + F_LEN] = l;
    hot[base + F_CNT] = 0;
    fpos.push_back(-1);
    clone.push_back(0);
    return (int32_t)(states++);
  }

  int32_t &len(int32_t v) { return hot[(size_t)v * STRIDE + F_LEN]; }
  int32_t &link(int32_t v) { return hot[(size_t)v * STRIDE + F_LINK]; }
  int32_t &nxt(int32_t v, int c) { return hot[(size_t)v * STRIDE + F_NXT + c]; }
  int32_t &cnt(int32_t v) { return hot[(size_t)v * STRIDE + F_CNT]; }
  int32_t len(int32_t v) const { return hot[(size_t)v * STRIDE + F_LEN]; }
  int32_t link(int32_t v) const { return hot[(size_t)v * STRIDE + F_LINK]; }
  int32_t nxt(int32_t v, int c) const { return hot[(size_t)v * STRIDE + F_NXT + c]; }
  int32_t cnt(int32_t v) const { return hot[(size_t)v * STRIDE + F_CNT]; }
};

static inline int code5(uint8_t c) { return c < 4 ? c : 4; }

static Sam *build(const uint8_t *ref, int64_t n) {
  Sam *s = new Sam();
  s->n = n;
  s->hot.reserve((size_t)STRIDE * (2 * n + 2));
  s->fpos.reserve(2 * n + 2);
  s->clone.reserve(2 * n + 2);
  int32_t last = s->add_state(0);  // root = 0
  for (int64_t t = 0; t < n; t++) {
    const int c = code5(ref[n - 1 - t]);  // reversed text
    const int32_t cur = s->add_state(s->len(last) + 1);
    s->fpos[cur] = (int32_t)t;  // end position (rev domain)
    int32_t p = last;
    while (p != -1 && s->nxt(p, c) == -1) {
      s->nxt(p, c) = cur;
      p = s->link(p);
    }
    if (p == -1) {
      s->link(cur) = 0;
    } else {
      const int32_t q = s->nxt(p, c);
      if (s->len(p) + 1 == s->len(q)) {
        s->link(cur) = q;
      } else {
        const int32_t cl = s->add_state(s->len(p) + 1);
        for (int a = 0; a < SIGMA; a++) s->nxt(cl, a) = s->nxt(q, a);
        s->link(cl) = s->link(q);
        s->fpos[cl] = s->fpos[q];
        s->clone[cl] = 1;
        while (p != -1 && s->nxt(p, c) == q) {
          s->nxt(p, c) = cl;
          p = s->link(p);
        }
        s->link(q) = cl;
        s->link(cur) = cl;
      }
    }
    last = cur;
  }
  // endpos sizes by counting-sort over len (cnt slots start at 0;
  // primaries seed 1), propagated along suffix links in len order.
  const int32_t ns = (int32_t)s->states;
  for (int32_t v = 1; v < ns; v++)
    if (!s->clone[v]) s->cnt(v) = 1;
  std::vector<int32_t> bucket((size_t)n + 2, 0);
  for (int32_t v = 0; v < ns; v++) bucket[s->len(v)]++;
  for (int64_t l = 1; l <= n + 1; l++) bucket[l] += bucket[l - 1];
  std::vector<int32_t> order(ns);
  for (int32_t v = 0; v < ns; v++) order[--bucket[s->len(v)]] = v;
  for (int32_t k = ns - 1; k > 0; k--) {
    const int32_t v = order[k];
    if (s->link(v) >= 0) s->cnt(s->link(v)) += s->cnt(v);
  }
  s->hot.shrink_to_fit();
  s->fpos.shrink_to_fit();
  s->clone.shrink_to_fit();
  return s;
}


static void prepare_tour(Sam *s) {
  if (!s->tour_lo.empty()) return;
  const int32_t ns = (int32_t)s->states;
  // children CSR over the link tree (root = 0)
  std::vector<int32_t> head(ns + 1, 0);
  for (int32_t v = 1; v < ns; v++) head[s->link(v) + 1]++;
  for (int32_t v = 0; v < ns; v++) head[v + 1] += head[v];
  std::vector<int32_t> child(ns > 0 ? ns - 1 : 0);
  std::vector<int32_t> cursor(head.begin(), head.end() - 1);
  for (int32_t v = 1; v < ns; v++) child[cursor[s->link(v)]++] = v;
  s->tour_lo.assign(ns, 0);
  s->tour_hi.assign(ns, 0);
  s->pos_list.reserve((size_t)s->n);
  // iterative DFS; next[v] tracks the next unvisited child slot
  std::vector<int32_t> next(head.begin(), head.end() - 1);
  std::vector<int32_t> stack;
  stack.reserve(1024);
  stack.push_back(0);
  s->tour_lo[0] = 0;
  while (!stack.empty()) {
    const int32_t v = stack.back();
    if (next[v] < head[v + 1]) {
      const int32_t c = child[next[v]++];
      s->tour_lo[c] = (int32_t)s->pos_list.size();
      if (!s->clone[c]) s->pos_list.push_back(s->fpos[c]);
      stack.push_back(c);
    } else {
      s->tour_hi[v] = (int32_t)s->pos_list.size();
      stack.pop_back();
    }
  }
}

}  // namespace sam_impl

// Prepare the link-tree Euler tour (idempotent; called lazily before
// the first maxmatch stream on this index).
void sam_prepare_tour(void *h) {
  sam_impl::prepare_tour((sam_impl::Sam *)h);
}

// All right-maximal matches of qry vs the indexed ref with length >=
// min_len (nucmer --maxmatch minus the left-maximality filter, which
// the caller applies vectorised).  Per query start j the deepest
// matched state emits occurrences at length ms[j]; each suffix-link
// ancestor v emits endpos(v) \ endpos(child-on-path) at length len[v]
// exactly -- the excluded occurrences continue matching deeper, so
// every (i, j) pair appears once, at its exact pairwise LCP.
// Writes up to cap rows into (out_i, out_j, out_l); returns the TOTAL
// count (callers re-run with a bigger buffer when count > cap).
int64_t sam_stream_maxmatch(const void *h, const uint8_t *qry, int64_t m,
                            int32_t min_len, int64_t *out_i, int64_t *out_j,
                            int64_t *out_l, int64_t cap) {
  const sam_impl::Sam *s = (const sam_impl::Sam *)h;
  int64_t count = 0;
  int32_t cur = 0;
  int32_t l = 0;
  for (int64_t j = m - 1; j >= 0; j--) {
    const uint8_t raw = qry[j];
    if (raw >= 4) {
      cur = 0;
      l = 0;
      continue;
    }
    const int c = raw;
    while (cur != 0 && s->nxt(cur, c) == -1) {
      cur = s->link(cur);
      l = s->len(cur);
    }
    const int32_t t = s->nxt(cur, c);
    if (t != -1) {
      cur = t;
      l++;
    } else {
      l = 0;
    }
    if (l < min_len) continue;
    int32_t v = cur;
    int32_t prev = -1;
    while (v != 0) {
      const int32_t match_len = (prev == -1) ? l : s->len(v);
      if (match_len < min_len) break;
      const int32_t lo = s->tour_lo[v];
      const int32_t hi = s->tour_hi[v];
      const int32_t skip_lo = (prev == -1) ? hi : s->tour_lo[prev];
      const int32_t skip_hi = (prev == -1) ? hi : s->tour_hi[prev];
      for (int32_t t2 = lo; t2 < hi; t2++) {
        // Guard skip_lo < skip_hi: an empty child tour range (impossible
        // today -- every non-root state's link subtree holds >= 1 primary
        // position -- but only implicitly so) would otherwise make this
        // jump re-land on t2 == skip_lo forever.
        if (t2 == skip_lo && skip_lo < skip_hi) {
          t2 = skip_hi - 1;  // jump over the child's range
          continue;
        }
        if (count < cap) {
          out_i[count] = s->n - 1 - (int64_t)s->pos_list[t2];
          out_j[count] = j;
          out_l[count] = match_len;
        }
        count++;
      }
      prev = v;
      v = s->link(v);
    }
  }
  return count;
}


void *sam_build(const uint8_t *ref, int64_t n) {
  return (void *)sam_impl::build(ref, n);
}

void sam_free(void *h) { delete (sam_impl::Sam *)h; }

int64_t sam_states(const void *h) {
  return ((const sam_impl::Sam *)h)->states;
}

// Matching statistics of qry against the indexed ref.  For each forward
// query position j: ms_len[j] = longest prefix of qry[j:] occurring in
// ref (ambiguous query bases reset the match: they never pair), and
// ref_start[j] = forward ref start of the occurrence when it is unique
// in ref, else -1.
void sam_stream_ms(const void *h, const uint8_t *qry, int64_t m,
                   int32_t *ms_len, int64_t *ref_start) {
  const sam_impl::Sam *s = (const sam_impl::Sam *)h;
  int32_t cur = 0;
  int32_t l = 0;
  for (int64_t j = m - 1; j >= 0; j--) {
    const uint8_t raw = qry[j];
    if (raw >= 4) {  // ambiguous: matches nothing (MUMmer semantics)
      cur = 0;
      l = 0;
      ms_len[j] = 0;
      ref_start[j] = -1;
      continue;
    }
    const int c = raw;
    while (cur != 0 && s->nxt(cur, c) == -1) {
      cur = s->link(cur);
      l = s->len(cur);
    }
    const int32_t t = s->nxt(cur, c);
    if (t != -1) {
      cur = t;
      l++;
    } else {
      l = 0;  // cur == root, no transition
    }
    ms_len[j] = l;
    if (l > 0 && s->cnt(cur) == 1)
      ref_start[j] = s->n - 1 - (int64_t)s->fpos[cur];
    else
      ref_start[j] = -1;
  }
}

// The lane count of sam_stream_ms_lanes for a query of m bases: one lane
// a MS_LANE_MIN bases, at most MS_LANES_MAX; 1 runs sam_stream_ms.
int32_t sam_ms_lanes(int64_t m) {
  const int64_t k = m / sam_impl::MS_LANE_MIN;
  return (int32_t)(k < 1 ? 1 : (k > sam_impl::MS_LANES_MAX ? sam_impl::MS_LANES_MAX : k));
}

// sam_stream_ms's output, position for position, from sam_ms_lanes(m)
// contiguous lanes of the query streamed in lockstep.  Each lane streams
// right to left from the root and prefetches the state its next step
// reads, so one thread keeps a miss in flight a lane where the serial
// stream keeps one: on a query that matches little (a minus strand) every
// step falls down suffix links to random states of a far larger array
// than the caches.
//
// A lane [lo, hi) reads min(ms[j], hi - j) at j: the prefixes of a string
// that occurs in ref occur too.  Where that equals ms[j], the string, and
// so the state, is the serial stream's, and so is every step further
// left, since ms[j - 1] <= ms[j] + 1.  So a lane can be wrong only on one
// run at its right end.  The fix-up continues the (already exact) stream
// of the lane to the right into it, rewriting ms_len and ref_start until
// the continued length meets the lane's, rightmost boundary first.
// Returns the positions the fix-up streamed again (0 with one lane).
int64_t sam_stream_ms_lanes(const void *h, const uint8_t *qry, int64_t m,
                            int32_t *ms_len, int64_t *ref_start) {
  using namespace sam_impl;
  const int L = sam_ms_lanes(m);
  if (L == 1) {
    sam_stream_ms(h, qry, m, ms_len, ref_start);
    return 0;
  }
  const Sam *s = (const Sam *)h;
  const int32_t *hot = s->hot.data();
  const int32_t *fpos = s->fpos.data();
  const int64_t n1 = s->n - 1;
  struct Lane {
    int64_t j;    // next position to stream
    int64_t lo;   // the lane's first position
    int64_t out;  // position whose ref_start waits for cur's block, or -1
    int32_t cur, l;
    bool pend;  // l is len(cur), read with cur's block (after a link)
  };
  Lane lane[MS_LANES_MAX];
  int32_t fin_cur[MS_LANES_MAX], fin_l[MS_LANES_MAX];
  int active[MS_LANES_MAX];
  for (int k = 0; k < L; k++) {
    lane[k] = {m * (k + 1) / L - 1, m * k / L, -1, 0, 0, false};
    active[k] = k;
  }
  int live = L;
  while (live) {
    for (int a = 0; a < live;) {
      Lane &z = lane[active[a]];
      const int32_t *blk = hot + (size_t)z.cur * STRIDE;
      if (z.pend) {
        z.l = blk[F_LEN];
        z.pend = false;
      }
      if (z.out >= 0) {  // l > 0: the step that set out was a transition
        ref_start[z.out] = blk[F_CNT] == 1 ? n1 - (int64_t)fpos[z.cur] : -1;
        z.out = -1;
      }
      if (z.j < z.lo) {
        fin_cur[active[a]] = z.cur;
        fin_l[active[a]] = z.l;
        active[a] = active[--live];
        continue;
      }
      const uint8_t raw = qry[z.j];
      if (raw >= 4) {  // ambiguous: matches nothing
        z.cur = 0;
        z.l = 0;
        ms_len[z.j] = 0;
        ref_start[z.j--] = -1;
        a++;
        continue;
      }
      const int32_t t = blk[F_NXT + raw];
      if (t == -1 && z.cur != 0) {
        z.cur = blk[F_LINK];
        z.pend = true;
      } else if (t != -1) {
        z.cur = t;
        ms_len[z.j] = ++z.l;
        z.out = z.j--;
        __builtin_prefetch(fpos + t);
      } else {  // root, no transition
        z.l = 0;
        ms_len[z.j] = 0;
        ref_start[z.j--] = -1;
      }
      // a block may straddle two cache lines
      const int32_t *next = hot + (size_t)z.cur * STRIDE;
      __builtin_prefetch(next);
      __builtin_prefetch(next + STRIDE - 1);
      a++;
    }
  }
  int64_t rewalked = 0;
  for (int k = L - 2; k >= 0; k--) {
    int32_t cur = fin_cur[k + 1];
    int32_t l = fin_l[k + 1];
    const int64_t lo = m * k / L;
    int64_t j = m * (k + 1) / L - 1;
    for (; j >= lo; j--) {
      rewalked++;
      const uint8_t raw = qry[j];
      if (raw >= 4) {
        cur = 0;
        l = 0;
      } else {
        const int c = raw;
        while (cur != 0 && s->nxt(cur, c) == -1) {
          cur = s->link(cur);
          l = s->len(cur);
        }
        const int32_t t = s->nxt(cur, c);
        if (t != -1) {
          cur = t;
          l++;
        } else {
          l = 0;
        }
      }
      if (l == ms_len[j]) break;  // the same string: the lane is exact from here
      ms_len[j] = l;
      ref_start[j] = s->cnt(cur) == 1 ? n1 - (int64_t)s->fpos[cur] : -1;
    }
    if (j < lo) {  // the whole lane was rewritten: it ends where the stream did
      fin_cur[k] = cur;
      fin_l[k] = l;
    }
  }
  return rewalked;
}

// ANIm's MUMs from the matching statistics of sam_stream_ms(_lanes), in
// two linear passes where a sort over every candidate would be (ops/
// suffix.py mum_matches_indexed).  A candidate is a query start j with
// ms_len[j] >= min_len and a ref start i = ref_start[j] >= 0.  Pass 1
// keeps, per ref start, the longest candidate in one word of a table
// over ref (length << 32 | j + 1; the low half 0 where a second
// candidate ties that length: the match then repeats in qry, and the
// group keeps none).  Pass 2 walks the table in ascending ref start and
// keeps each untied maximum that is left-maximal: j == 0, i == 0,
// ref[i-1] != qry[j-1] or ref[i-1] >= 4 (ambiguous bases never extend a
// match).  The k MUMs are written over the fronts of the stream arrays,
// which pass 1 has read in full (k <= the candidates <= m):
// ref_start[t] = j << 32 | i and ms_len[t] = the length, so positions
// stay below 2^31 (the automaton's are int32).  A ref start outside
// [0, n) is no candidate.  *candidates = the candidates; returns k, or
// -1 where the table could not be allocated.
int64_t sam_select_mums(int32_t *ms_len, int64_t *ref_start, int64_t m,
                        const uint8_t *ref, int64_t n, const uint8_t *qry,
                        int32_t min_len, int64_t *candidates) {
  // The stream gives a ref start only to a match of a base or more, so a
  // candidate's length is never 0 and a word of 0 is an empty ref start.
  if (min_len < 1) min_len = 1;
  // calloc: the pages of ref starts that no candidate hits (most of them
  // on a minus strand) are never written, and so never allocated.
  std::unique_ptr<uint64_t, decltype(&std::free)> table(
      (uint64_t *)std::calloc(n > 0 ? n : 1, sizeof(uint64_t)), &std::free);
  uint64_t *best = table.get();
  if (best == nullptr) return -1;
  int64_t found = 0;
  for (int64_t j = 0; j < m; j++) {
    const int32_t l = ms_len[j];
    const int64_t i = ref_start[j];
    if (l < min_len || i < 0 || i >= n) continue;
    found++;
    const uint64_t word = best[i];
    const uint32_t top = (uint32_t)(word >> 32);
    if ((uint32_t)l > top)
      best[i] = (uint64_t)l << 32 | (uint64_t)(j + 1);
    else if ((uint32_t)l == top)
      best[i] = word >> 32 << 32;  // tied
  }
  *candidates = found;
  int64_t k = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint64_t word = best[i];
    const uint32_t j1 = (uint32_t)word;
    if (j1 == 0) continue;  // empty or tied
    const int64_t j = j1 - 1;
    if (j == 0 || i == 0 || ref[i - 1] != qry[j - 1] || ref[i - 1] >= 4) {
      ref_start[k] = (int64_t)((uint64_t)j << 32 | (uint64_t)i);
      ms_len[k] = (int32_t)(word >> 32);
      k++;
    }
  }
  return k;
}

// Suffix array of arbitrary int64 symbols (name kept for ABI compat
// with the previous prefix-doubling entry point).
void suffix_array_pd(const int64_t *text, int64_t n, int64_t *sa) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  // Dense order-preserving remap to [1, K); sentinel 0 appended.
  std::vector<int64_t> sorted(text, text + n);
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());
  const int64_t n2 = n + 1;
  std::vector<int64_t> T(n2);
  for (int64_t i = 0; i < n; i++)
    T[i] = 1 + (std::lower_bound(sorted.begin(), sorted.end(), text[i]) -
                sorted.begin());
  T[n] = 0;
  std::vector<int64_t> SA(n2);
  sais_impl::sais(T.data(), SA.data(), n2, (int64_t)sorted.size() + 1);
  // Drop the sentinel suffix (always rank 0)
  for (int64_t i = 1; i < n2; i++) sa[i - 1] = SA[i];
}

}  // extern "C"
