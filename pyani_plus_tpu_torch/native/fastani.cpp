// Native host-side kernels for the fastANI-mode mapping core.
//
// Replaces the two numpy hot paths of ops/fastani_map.py / ops/minimizers.py
// (the TPU-native stand-in for the fastANI binary's vendored MashMap2,
// SURVEY.md section 2.2 row fastANI):
//
//  1. fastani_winnow -- MashMap-style winnowed minimizer extraction
//     (CommonFunc::addMinimizers semantics: canonical murmur3-x64-128-low
//     over raw uppercase bytes, strand-symmetric k-mers skipped, rightmost
//     window minimum, consecutive identical picks grouped into pick runs).
//     Monotonic-deque sweep, O(n).
//
//  2. fastani_eval_region -- the per-candidate-region winnowed-minhash
//     maximisation: over every window anchor event, count query-sketch
//     hashes among the s smallest hashes of the union of the query sketch
//     and the reference substring sketch. The numpy oracle materialises a
//     dense (events x domain) membership matrix with two cumsums; here a
//     sweep over events maintains two Fenwick trees (union membership,
//     shared membership) and answers each event with a find-kth + prefix
//     sum: O((runs + events) log domain) instead of O(events * domain).
//
// Both are bit-identical to the numpy oracles (tests/test_fastani.py fuzz
// parity) -- keep it that way.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 fastani.cpp -o libfastani.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

static inline uint64_t load64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian host assumed
}

// MurmurHash3 x64-128, first 64 bits; buffer must be readable for
// ((len+15)/16)*16 bytes (callers overallocate by 16).
static inline uint64_t murmur3_x64_128_low(const uint8_t *data, int len,
                                           uint32_t seed) {
  const int nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;

  for (int i = 0; i < nblocks; i++) {
    uint64_t k1 = load64(data + i * 16);
    uint64_t k2 = load64(data + i * 16 + 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }

  const uint8_t *tail = data + nblocks * 16;
  const int rem = len & 15;
  if (rem > 8) {
    const int r2 = rem - 8;
    uint64_t k2 = load64(tail + 8) & ((1ULL << (8 * r2)) - 1);
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    uint64_t k1 = load64(tail);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  } else if (rem == 8) {
    uint64_t k1 = load64(tail);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  } else if (rem > 0) {
    uint64_t k1 = load64(tail) & ((1ULL << (8 * rem)) - 1);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= (uint64_t)len;
  h2 ^= (uint64_t)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  return h1;
}

namespace {

struct Fenwick {
  std::vector<int32_t> t;
  int n = 0;
  int log2n = 0;
  void init(int n_) {
    n = n_;
    t.assign((size_t)n + 1, 0);
    log2n = 0;
    while ((1 << (log2n + 1)) <= n) log2n++;
  }
  void add(int i, int v) {
    for (++i; i <= n; i += i & -i) t[(size_t)i] += v;
  }
  // sum of elements at 0-based indices [0, i)
  int prefix(int i) const {
    int s = 0;
    for (; i > 0; i -= i & -i) s += t[(size_t)i];
    return s;
  }
  // 0-based index of the k-th set element (1-based k, k <= total)
  int kth(int k) const {
    int pos = 0;
    for (int pw = 1 << log2n; pw > 0; pw >>= 1) {
      if (pos + pw <= n && t[(size_t)(pos + pw)] < k) {
        pos += pw;
        k -= t[(size_t)pos];
      }
    }
    return pos;  // prefix(pos) < k_orig <= prefix(pos+1)
  }
};

// Max shared count over event windows (see module comment).
//   qh[nq]            sorted unique query sketch hashes
//   eh/ef/el[ne]      region pick runs: hash, first step, last step
//   ev[nev]           ascending window anchor steps to evaluate
//   region_b          last anchor position of the region (for the
//                     plateau-end extension; pass ev[nev-1] to disable)
// A run is active at anchor t iff t in [ef - w_steps + 1, el].
// out[0] = best shared count, out[1] = anchor step of the first maximum,
// out[2] = plateau end: the last integer anchor still achieving the
// maximum (the step function is constant between events, so this is
// the event AFTER the last maximal event minus one, or region_b when
// the plateau runs to the region end). fastANI's L2 reports this
// trailing optimal position (validated against the fixture bin-dedup
// counts; see CLAUDE.md fastANI notes).
static void eval_region_impl(const uint64_t *qh, int64_t nq,
                             const uint64_t *eh, const int64_t *ef,
                             const int64_t *el, int64_t ne, const int64_t *ev,
                             int64_t nev, int64_t w_steps, int64_t s,
                             int64_t region_b, int64_t *out) {
  out[0] = 0;
  out[1] = nev ? ev[0] : 0;
  out[2] = nev ? region_b : 0;
  if (!nev || !ne) return;

  // Domain = sorted union of query hashes and run hashes.
  std::vector<uint64_t> eh_u(eh, eh + ne);
  std::sort(eh_u.begin(), eh_u.end());
  eh_u.erase(std::unique(eh_u.begin(), eh_u.end()), eh_u.end());
  std::vector<uint64_t> domain((size_t)nq + eh_u.size());
  std::merge(qh, qh + nq, eh_u.begin(), eh_u.end(), domain.begin());
  domain.erase(std::unique(domain.begin(), domain.end()), domain.end());
  const int D = (int)domain.size();

  std::vector<uint8_t> in_query((size_t)D, 0);
  {
    size_t j = 0;
    for (int64_t i = 0; i < nq; i++) {
      while (domain[j] < qh[i]) j++;
      in_query[j] = 1;
    }
  }

  // Bucket run activations/deactivations per event index (CSR).
  std::vector<int32_t> run_lo((size_t)ne), run_hi((size_t)ne),
      run_d((size_t)ne);
  std::vector<int32_t> add_cnt((size_t)nev + 1, 0), rem_cnt((size_t)nev + 1, 0);
  for (int64_t i = 0; i < ne; i++) {
    const int32_t lo =
        (int32_t)(std::lower_bound(ev, ev + nev, ef[i] - w_steps + 1) - ev);
    const int32_t hi = (int32_t)(std::upper_bound(ev, ev + nev, el[i]) - ev);
    run_lo[(size_t)i] = lo;
    run_hi[(size_t)i] = hi;
    run_d[(size_t)i] = (int32_t)(std::lower_bound(domain.begin(), domain.end(),
                                                  eh[i]) -
                                 domain.begin());
    if (lo < hi) {
      add_cnt[(size_t)lo + 1]++;
      if (hi < nev) rem_cnt[(size_t)hi + 1]++;
    }
  }
  for (int64_t j = 0; j < nev; j++) {
    add_cnt[(size_t)j + 1] += add_cnt[(size_t)j];
    rem_cnt[(size_t)j + 1] += rem_cnt[(size_t)j];
  }
  std::vector<int32_t> add_runs((size_t)add_cnt[(size_t)nev]);
  std::vector<int32_t> rem_runs((size_t)rem_cnt[(size_t)nev]);
  {
    std::vector<int32_t> ap(add_cnt.begin(), add_cnt.end() - 1);
    std::vector<int32_t> rp(rem_cnt.begin(), rem_cnt.end() - 1);
    for (int64_t i = 0; i < ne; i++) {
      if (run_lo[(size_t)i] >= run_hi[(size_t)i]) continue;
      add_runs[(size_t)ap[(size_t)run_lo[(size_t)i]]++] = (int32_t)i;
      if (run_hi[(size_t)i] < nev)
        rem_runs[(size_t)rp[(size_t)run_hi[(size_t)i]]++] = (int32_t)i;
    }
  }

  Fenwick bit_union, bit_shared;
  bit_union.init(D);
  bit_shared.init(D);
  std::vector<int32_t> ref_count((size_t)D, 0);
  int union_total = 0, shared_total = 0;
  for (int d = 0; d < D; d++)
    if (in_query[(size_t)d]) {
      bit_union.add(d, 1);
      union_total++;
    }

  int64_t best_shared = 0, best_t = ev[0], last_max_j = 0;
  for (int64_t j = 0; j < nev; j++) {
    for (int32_t a = add_cnt[(size_t)j]; a < add_cnt[(size_t)j + 1]; a++) {
      const int d = run_d[(size_t)add_runs[(size_t)a]];
      if (ref_count[(size_t)d]++ == 0) {
        if (in_query[(size_t)d]) {
          bit_shared.add(d, 1);
          shared_total++;
        } else {
          bit_union.add(d, 1);
          union_total++;
        }
      }
    }
    for (int32_t r = rem_cnt[(size_t)j]; r < rem_cnt[(size_t)j + 1]; r++) {
      const int d = run_d[(size_t)rem_runs[(size_t)r]];
      if (--ref_count[(size_t)d] == 0) {
        if (in_query[(size_t)d]) {
          bit_shared.add(d, -1);
          shared_total--;
        } else {
          bit_union.add(d, -1);
          union_total--;
        }
      }
    }
    int64_t shared_j;
    if (union_total <= s) {
      shared_j = shared_total;
    } else {
      const int p = bit_union.kth((int)s);
      shared_j = bit_shared.prefix(p + 1);
    }
    if (shared_j > best_shared) {
      best_shared = shared_j;
      best_t = ev[j];
      last_max_j = j;
    } else if (shared_j == best_shared) {
      last_max_j = j;
    }
  }
  out[0] = best_shared;
  out[1] = best_t;
  out[2] = (last_max_j + 1 < nev) ? ev[last_max_j + 1] - 1 : region_b;
}

// Evaluate one merged candidate region [a, b] of one sequence whose index
// entries occupy [b_lo, b_hi). Runs that can appear in any window anchored
// in [a, b] are those with last >= a and first <= b + w_steps - 1 -- a
// contiguous entry range since first and last steps are each ascending
// within a sequence (the numpy oracle's boolean run_mask selects exactly
// this set). Events are every content-change anchor clipped to [a, b].
// out[0]=best shared, out[1]=first-max anchor, out[2]=plateau end.
static void eval_merged_region(const uint64_t *ref_hash,
                               const int64_t *ref_first,
                               const int64_t *ref_last, int64_t b_lo,
                               int64_t b_hi, int64_t a, int64_t b,
                               const uint64_t *qh, int64_t nq, int64_t w_steps,
                               int64_t s, std::vector<int64_t> &events,
                               int64_t *out) {
  out[0] = 0;
  out[1] = -1;
  out[2] = -1;
  const int64_t *last_begin = ref_last + b_lo;
  const int64_t *last_end = ref_last + b_hi;
  const int64_t rlo =
      b_lo + (std::lower_bound(last_begin, last_end, a) - last_begin);
  const int64_t *first_begin = ref_first + b_lo;
  const int64_t *first_end = ref_first + b_hi;
  const int64_t rhi =
      b_lo + (std::upper_bound(first_begin, first_end, b + w_steps - 1) -
              first_begin);
  if (rlo >= rhi) return;
  const int64_t nr = rhi - rlo;
  events.clear();
  events.reserve((size_t)(2 * nr + 1));
  events.push_back(a);
  for (int64_t i = rlo; i < rhi; i++) {
    int64_t e1 = ref_first[i] - w_steps + 1;
    int64_t e2 = ref_last[i] + 1;
    events.push_back(e1 < a ? a : (e1 > b ? b : e1));
    events.push_back(e2 < a ? a : (e2 > b ? b : e2));
  }
  std::sort(events.begin(), events.end());
  events.erase(std::unique(events.begin(), events.end()), events.end());
  eval_region_impl(qh, nq, ref_hash + rlo, ref_first + rlo, ref_last + rlo,
                   nr, events.data(), (int64_t)events.size(), w_steps, s, b,
                   out);
}

}  // namespace

extern "C" {

void fastani_eval_region(const uint64_t *qh, int64_t nq, const uint64_t *eh,
                         const int64_t *ef, const int64_t *el, int64_t ne,
                         const int64_t *ev, int64_t nev, int64_t w_steps,
                         int64_t s, int64_t region_b, int64_t *out) {
  eval_region_impl(qh, nq, eh, ef, el, ne, ev, nev, w_steps, s, region_b,
                   out);
}

// Like fastani_eval_region but writes the shared count of EVERY event
// window into out_shared[nev] (experiment/diagnostic surface for L2
// semantics studies; the sweep itself is identical).
void fastani_eval_region_all(const uint64_t *qh, int64_t nq,
                             const uint64_t *eh, const int64_t *ef,
                             const int64_t *el, int64_t ne, const int64_t *ev,
                             int64_t nev, int64_t w_steps, int64_t s,
                             int64_t *out_shared) {
  if (!nev) return;
  for (int64_t j = 0; j < nev; j++) out_shared[j] = 0;
  if (!ne) return;
  std::vector<uint64_t> eh_u(eh, eh + ne);
  std::sort(eh_u.begin(), eh_u.end());
  eh_u.erase(std::unique(eh_u.begin(), eh_u.end()), eh_u.end());
  std::vector<uint64_t> domain((size_t)nq + eh_u.size());
  std::merge(qh, qh + nq, eh_u.begin(), eh_u.end(), domain.begin());
  domain.erase(std::unique(domain.begin(), domain.end()), domain.end());
  const int D = (int)domain.size();
  std::vector<uint8_t> in_query((size_t)D, 0);
  {
    size_t j = 0;
    for (int64_t i = 0; i < nq; i++) {
      while (domain[j] < qh[i]) j++;
      in_query[j] = 1;
    }
  }
  Fenwick bit_union, bit_shared;
  bit_union.init(D);
  bit_shared.init(D);
  std::vector<int32_t> ref_count((size_t)D, 0);
  int union_total = 0, shared_total = 0;
  for (int d = 0; d < D; d++)
    if (in_query[(size_t)d]) {
      bit_union.add(d, 1);
      union_total++;
    }
  // Per-event add/remove lists (same bucketing as eval_region_impl).
  std::vector<std::vector<int32_t>> adds((size_t)nev), rems((size_t)nev);
  for (int64_t i = 0; i < ne; i++) {
    const int64_t lo =
        std::lower_bound(ev, ev + nev, ef[i] - w_steps + 1) - ev;
    const int64_t hi = std::upper_bound(ev, ev + nev, el[i]) - ev;
    if (lo >= hi) continue;
    const int32_t d = (int32_t)(std::lower_bound(domain.begin(), domain.end(),
                                                 eh[i]) -
                                domain.begin());
    adds[(size_t)lo].push_back(d);
    if (hi < nev) rems[(size_t)hi].push_back(d);
  }
  for (int64_t j = 0; j < nev; j++) {
    for (int32_t d : adds[(size_t)j])
      if (ref_count[(size_t)d]++ == 0) {
        if (in_query[(size_t)d]) {
          bit_shared.add(d, 1);
          shared_total++;
        } else {
          bit_union.add(d, 1);
          union_total++;
        }
      }
    for (int32_t d : rems[(size_t)j])
      if (--ref_count[(size_t)d] == 0) {
        if (in_query[(size_t)d]) {
          bit_shared.add(d, -1);
          shared_total--;
        } else {
          bit_union.add(d, -1);
          union_total--;
        }
      }
    if (union_total <= s) {
      out_shared[j] = shared_total;
    } else {
      const int p = bit_union.kth((int)s);
      out_shared[j] = bit_shared.prefix(p + 1);
    }
  }
}

// Full L2 mapping of one fragment sketch against a reference index
// (oracle: ops/fastani_map.py map_fragment from the L1 join onward).
//
//   qh[nq]                     sorted unique fragment sketch hashes
//   ref_hash/first/last/seq    index entries grouped by sequence, position
//                              order (first/last ascending within a seq)
//   ref_hash_sorted[n]         one-time sort of ref_hash
//   ref_sorted_entry[n]        argsort indices (sorted pos -> entry)
//   seq_lo/seq_hi/seq_ids      per-present-sequence entry ranges
//   frag_span                  fastANI's L1 candidate span (Q.len = the
//                              fragment length in bases, NOT w_steps):
//                              each hit t seeds anchors [t-frag_span+1, t]
// Candidate regions are the merged per-hit intervals (fastANI's L1 with
// minimumHits relaxed to 1 -- the acceptance gate, not L1, does the
// filtering; validated against the fixture outputs).
// out[0]=best shared, out[1]=plateau-end anchor step (the last optimal
// window position -- what fastANI reports and bins by), out[2]=seq id
// (-1 when no hit).
void fastani_map_fragment(
    const uint64_t *qh, int64_t nq, const uint64_t *ref_hash,
    const int64_t *ref_first, const int64_t *ref_last, const int32_t *ref_seq,
    const uint64_t *ref_hash_sorted, const int64_t *ref_sorted_entry,
    int64_t n_entries, const int64_t *seq_lo, const int64_t *seq_hi,
    const int32_t *seq_ids, int64_t n_seqs, int64_t w_steps, int64_t s,
    int64_t frag_span, int64_t min_anchor, int64_t *out) {
  out[0] = 0;
  out[1] = -1;
  out[2] = -1;
  if (!nq || !n_entries) return;

  // L1: every index entry whose hash is in the fragment sketch.
  std::vector<std::pair<int32_t, int64_t>> hits;  // (seq, first_step)
  for (int64_t i = 0; i < nq; i++) {
    const uint64_t *lo =
        std::lower_bound(ref_hash_sorted, ref_hash_sorted + n_entries, qh[i]);
    const uint64_t *hi =
        std::upper_bound(lo, ref_hash_sorted + n_entries, qh[i]);
    for (const uint64_t *p = lo; p != hi; p++) {
      const int64_t e = ref_sorted_entry[p - ref_hash_sorted];
      hits.emplace_back(ref_seq[e], ref_first[e]);
    }
  }
  if (hits.empty()) return;
  std::sort(hits.begin(), hits.end());

  int64_t best_shared = 0, best_t = -1, best_seq = -1;
  std::vector<int64_t> events, t_hits;
  int64_t eval_out[3];

  size_t g = 0;
  for (int64_t sq = 0; sq < n_seqs; sq++) {
    const int32_t sid = seq_ids[sq];
    // Hits are (seq, t) ascending; sequences present in the index are
    // visited in ascending id order, matching the hits grouping.
    t_hits.clear();
    while (g < hits.size() && hits[g].first < sid) g++;
    while (g < hits.size() && hits[g].first == sid)
      t_hits.push_back(hits[g++].second);
    const int64_t cnt = (int64_t)t_hits.size();
    if (!cnt) continue;

    // Merged per-hit candidate anchor intervals [a, b].
    const int64_t b_lo = seq_lo[sq], b_hi = seq_hi[sq];
    int64_t reg_a = -1, reg_b = -1;
    bool have_region = false;
    for (int64_t j = 0; j < cnt; j++) {
      int64_t a = t_hits[(size_t)j] - frag_span + 1;
      if (a < min_anchor) a = min_anchor;
      int64_t b = t_hits[(size_t)j];
      if (b < a) b = a;
      if (have_region && a <= reg_b) {
        if (b > reg_b) reg_b = b;
        continue;
      }
      if (have_region) {
        // flush the previous region
        eval_merged_region(ref_hash, ref_first, ref_last, b_lo, b_hi, reg_a,
                           reg_b, qh, nq, w_steps, s, events, eval_out);
        if (eval_out[0] > best_shared) {
          best_shared = eval_out[0];
          best_t = eval_out[2];
          best_seq = sid;
        }
      }
      reg_a = a;
      reg_b = b;
      have_region = true;
    }
    if (have_region) {
      eval_merged_region(ref_hash, ref_first, ref_last, b_lo, b_hi, reg_a,
                         reg_b, qh, nq, w_steps, s, events, eval_out);
      if (eval_out[0] > best_shared) {
        best_shared = eval_out[0];
        best_t = eval_out[2];
        best_seq = sid;
      }
    }
  }
  out[0] = best_shared;
  out[1] = best_t;
  out[2] = best_seq;
}

// Winnowed minimizer pick runs of one raw byte sequence (MashMap
// addMinimizers semantics; numpy oracle: ops/minimizers.py
// window_minimizers). Writes up to cap runs; returns the total number of
// runs (caller re-calls with a larger cap if the return exceeds it).
int64_t fastani_winnow(const uint8_t *seq, int64_t n, int k, int w,
                       uint32_t seed, uint64_t *out_hash, int64_t *out_pos,
                       int8_t *out_strand, int64_t *out_first,
                       int64_t *out_last, int64_t cap) {
  if (n < k || w < 1) return 0;
  const int64_t n_win = n - k + 1;
  if (n_win < w) return 0;  // no full windows (oracle: n < w check)

  // Uppercase forward copy and complement-reversed copy, +16 slack for the
  // murmur tail loads. Non-ACGT bytes complement to themselves (N -> N),
  // and are hashed literally -- fastANI's behaviour.
  uint8_t comp[256];
  for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
  comp['A'] = 'T'; comp['C'] = 'G'; comp['G'] = 'C'; comp['T'] = 'A';
  std::vector<uint8_t> U((size_t)n + 16, 0), R((size_t)n + 16, 0);
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = seq[i];
    if (c >= 'a' && c <= 'z') c -= 32;
    U[(size_t)i] = c;
  }
  for (int64_t i = 0; i < n; i++) R[(size_t)i] = comp[U[(size_t)(n - 1 - i)]];

  const uint64_t SENTINEL = ~0ULL;
  // Monotonic deque over (position, masked value); ring buffers of the
  // last w per-position canonical/strand for run emission.
  std::vector<int64_t> dq_pos((size_t)n_win);
  std::vector<uint64_t> dq_val((size_t)n_win);
  int64_t dq_b = 0, dq_e = 0;  // [dq_b, dq_e)
  std::vector<uint64_t> ring_canon((size_t)w);
  std::vector<int8_t> ring_strand((size_t)w);

  int64_t count = 0;
  int64_t prev_pick = -1;

  for (int64_t i = 0; i < n_win; i++) {
    const uint64_t fwd = murmur3_x64_128_low(U.data() + i, k, seed);
    const uint64_t bwd =
        murmur3_x64_128_low(R.data() + (n - i - k), k, seed);
    const bool valid = fwd != bwd;
    const uint64_t canon = fwd < bwd ? fwd : bwd;
    const uint64_t masked = valid ? canon : SENTINEL;
    ring_canon[(size_t)(i % w)] = canon;
    ring_strand[(size_t)(i % w)] = fwd < bwd ? (int8_t)1 : (int8_t)-1;

    while (dq_b < dq_e && dq_pos[(size_t)dq_b] <= i - w) dq_b++;
    while (dq_b < dq_e && dq_val[(size_t)(dq_e - 1)] >= masked) dq_e--;
    dq_pos[(size_t)dq_e] = i;
    dq_val[(size_t)dq_e] = masked;
    dq_e++;

    if (i < w - 1 || !valid) continue;  // record only at valid steps
    const int64_t pick = dq_pos[(size_t)dq_b];
    if (pick != prev_pick) {
      if (count < cap) {
        out_hash[count] = ring_canon[(size_t)(pick % w)];
        out_pos[count] = pick;
        out_strand[count] = ring_strand[(size_t)(pick % w)];
        out_first[count] = i;
        out_last[count] = i;
      }
      count++;
      prev_pick = pick;
    } else if (count <= cap && count > 0) {
      out_last[count - 1] = i;
    }
  }
  return count;
}

}  // extern "C"
