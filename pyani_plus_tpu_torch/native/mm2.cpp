// minimap2-semantics sketch + chain kernels (host side).
//
// Replaces the minimap2 binary's seeding/chaining stages for the
// ANIminimap2 method (reference invocation private_cli.py:1499-1549;
// run WITHOUT -c, so PAF nmatch/blocklen are the chain's mlen/blen
// anchor accounting, not a base-level alignment). To reproduce those
// numbers bit-for-bit we mirror minimap2's exact semantics:
//
//  - mm_sketch: 2-bit packed k-mers, Thomas Wang invertible hash64 on
//    the canonical strand, window minima with minimap2's tie handling
//    (new-min push, ties flushed when the old minimum exits a window),
//    positions are k-mer END offsets, ambiguous bases reset the run;
//  - mm_chain_dp: f[i] = max(span, max_j f[j] + min(dq,dr,span) -
//    (int)(dd*0.01*avg_qspan) - (ilog2(dd)>>1)) over a bounded window
//    with minimap2's skip/termination heuristics (max_iter, max_skip,
//    t[] marking).
//
// Chain backtracking, primary filtering and PAF assembly stay in
// Python (pyani_plus_tpu/ops/mm2.py).
//
// Build: g++ -O3 -march=native -shared -fPIC mm2.cpp -o libmm2.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <set>
#include <utility>
#include <vector>

namespace {

inline uint64_t hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ key >> 24;
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ key >> 14;
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ key >> 28;
  key = (key + (key << 31)) & mask;
  return key;
}

struct MinEntry {
  uint64_t x;  // hash<<8 | kspan
  uint64_t y;  // pos<<1 | strand
};

// minimap2's fast float log2 approximation (misc.h mg_log2)
inline float mg_log2(float x) {
  union { float f; uint32_t i; } z = {x};
  float log_2 = (float)(((z.i >> 23) & 255) - 128);
  z.i &= ~(255u << 23);
  z.i += 127u << 23;
  log_2 += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
  return log_2;
}

}  // namespace

extern "C" {

// mm_sketch over a 0..3 code array (>=4 = ambiguous, resets the k-mer).
// Writes (hash, end_pos, strand01) triples in emission order; returns
// count (caller sizes out arrays to n).
int64_t mm2_sketch(const uint8_t *codes, int64_t n, int k, int w,
                   uint64_t *out_hash, int32_t *out_pos,
                   uint8_t *out_strand) {
  const uint64_t shift1 = 2 * (k - 1);
  const uint64_t mask = (1ULL << 2 * k) - 1;
  uint64_t kmer[2] = {0, 0};
  std::vector<MinEntry> buf(w);
  for (int j = 0; j < w; j++) buf[j] = {UINT64_MAX, UINT64_MAX};
  MinEntry mn = {UINT64_MAX, UINT64_MAX};
  int l = 0, buf_pos = 0, min_pos = 0;
  int64_t count = 0;

  auto push = [&](const MinEntry &e) {
    out_hash[count] = e.x >> 8;
    out_pos[count] = (int32_t)(e.y >> 1);
    out_strand[count] = (uint8_t)(e.y & 1);
    count++;
  };

  for (int64_t i = 0; i < n; i++) {
    const uint8_t c = codes[i];
    MinEntry info = {UINT64_MAX, UINT64_MAX};
    if (c < 4) {
      kmer[0] = (kmer[0] << 2 | c) & mask;
      kmer[1] = (kmer[1] >> 2) | ((uint64_t)(3 - c) << shift1);
      if (kmer[0] == kmer[1]) {
        // symmetric k-mer: skip but still advances l/buffer (minimap2
        // keeps info at UINT64_MAX for this position)
        l++;
      } else {
        const int z = kmer[0] < kmer[1] ? 0 : 1;
        l++;
        if (l >= k) {
          info.x = hash64(kmer[z], mask) << 8 | (uint64_t)k;
          info.y = (uint64_t)i << 1 | (uint64_t)z;
        }
      }
    } else {
      l = 0;
    }
    buf[buf_pos] = info;
    if (l == w + k - 1 && mn.x != UINT64_MAX) {
      // first full window: flush ties of the initial minimum
      for (int j = buf_pos + 1; j < w; j++)
        if (mn.x == buf[j].x && buf[j].y != mn.y) push(buf[j]);
      for (int j = 0; j < buf_pos; j++)
        if (mn.x == buf[j].x && buf[j].y != mn.y) push(buf[j]);
    }
    if (info.x <= mn.x) {
      // new (or equal) minimum: emit the previous one if window full
      if (l >= w + k && mn.x != UINT64_MAX) push(mn);
      mn = info;
      min_pos = buf_pos;
    } else if (buf_pos == min_pos) {
      // old minimum leaves the window: emit it, rescan for the new one
      if (l >= w + k - 1 && mn.x != UINT64_MAX) push(mn);
      mn.x = UINT64_MAX;
      for (int j = buf_pos + 1; j < w; j++)
        if (buf[j].x <= mn.x) { mn = buf[j]; min_pos = j; }
      for (int j = 0; j <= buf_pos; j++)
        if (buf[j].x <= mn.x) { mn = buf[j]; min_pos = j; }
      if (l >= w + k - 1 && mn.x != UINT64_MAX) {
        // flush ties of the new minimum
        for (int j = buf_pos + 1; j < w; j++)
          if (mn.x == buf[j].x && buf[j].y != mn.y) push(buf[j]);
        for (int j = 0; j <= buf_pos; j++)
          if (mn.x == buf[j].x && buf[j].y != mn.y) push(buf[j]);
      }
    }
    if (++buf_pos == w) buf_pos = 0;
  }
  if (mn.x != UINT64_MAX) push(mn);
  return count;
}

// mg_chain_rmq (lchain.c, minimap2 >= 2.24): the heuristic RMQ chain
// fill used by the asm presets. Differences from an exhaustive DP:
//  - candidate predecessors are (a) the single anchor maximising a
//    decomposable surrogate priority over the y-window
//    [y_i - max_dist, y_i] among anchors with x_j < x_i and
//    x_i - x_j <= max_dist (range-max query), plus (b) an "inner"
//    serial scan over recent anchors (x_i - x_j <= max_dist_inner)
//    iterated by descending y with the DP's skip-marking heuristic,
//    run only when the RMQ candidate is not an exact extension
//    (dd == 0 && dg <= span);
//  - the true score (comput_sc_simple: min(dq,dr,span) -
//    (int)(chn_pen_gap*dd + .5*mg_log2(dd+1))) gates on width
//    (dd <= bw);
//  - the active set is capped at cap_rmq_size by evicting smallest-x.
// pri_mode selects the surrogate: 0 -> f[j] + .5*c*(x_j+y_j),
// 1 -> f[j] + c*y_j, 2 -> f[j].
// flags bitmask (default 0 = production semantics): 1 = reject dq <= 0
// joins, 2 = run the inner scan even when the outer candidate is exact,
// 4 = open outer y-window lower bound (y_j > y_i - max_dist).
void mm2_chain_rmq2_f(const int64_t *ax, const int32_t *ay, int64_t n,
                      int32_t q_span, int32_t max_dist,
                      int32_t max_dist_inner, int32_t bw, int32_t max_skip,
                      int32_t cap_rmq_size, float chn_pen_gap,
                      int32_t pri_mode, int32_t flags, int32_t *f,
                      int64_t *p) {
  if (n == 0) return;
  // --- coordinate-compress y for the outer segment tree
  std::vector<int32_t> ys(ay, ay + n);
  std::sort(ys.begin(), ys.end());
  ys.erase(std::unique(ys.begin(), ys.end()), ys.end());
  const int32_t m = (int32_t)ys.size();
  int32_t size = 1;
  while (size < m) size <<= 1;
  const double NEG = -1e300;
  std::vector<double> seg(2 * size, NEG);
  std::vector<int64_t> seg_arg(2 * size, -1);
  auto seg_set = [&](int32_t leaf, double val, int64_t arg) {
    int32_t node = leaf + size;
    seg[node] = val;
    seg_arg[node] = arg;
    for (node >>= 1; node >= 1; node >>= 1) {
      const int32_t l = node << 1, r = l + 1;
      if (seg[l] >= seg[r]) {
        seg[node] = seg[l];
        seg_arg[node] = seg_arg[l];
      } else {
        seg[node] = seg[r];
        seg_arg[node] = seg_arg[r];
      }
    }
  };
  // range-max over compressed-y leaves [lo, hi] inclusive
  auto seg_query = [&](int32_t lo, int32_t hi) -> int64_t {
    double best = NEG;
    int64_t arg = -1;
    int32_t l = lo + size, r = hi + size + 1;
    while (l < r) {
      if (l & 1) {
        if (seg[l] > best) { best = seg[l]; arg = seg_arg[l]; }
        l++;
      }
      if (r & 1) {
        r--;
        if (seg[r] > best) { best = seg[r]; arg = seg_arg[r]; }
      }
      l >>= 1;
      r >>= 1;
    }
    return best <= NEG ? -1 : arg;
  };
  auto yleaf = [&](int32_t y) {  // index of y in ys (exact)
    return (int32_t)(std::lower_bound(ys.begin(), ys.end(), y) - ys.begin());
  };
  auto ylower = [&](int32_t y) {  // first leaf with ys[leaf] >= y
    return (int32_t)(std::lower_bound(ys.begin(), ys.end(), y) - ys.begin());
  };
  auto yupper = [&](int32_t y) {  // last leaf with ys[leaf] <= y
    return (int32_t)(std::upper_bound(ys.begin(), ys.end(), y) - ys.begin()) - 1;
  };
  // outer tree holds ONE element per distinct y (the max-pri anchor at
  // that y, as a krmq keyed on y effectively exposes the best); keep a
  // per-leaf bucket of active anchors to restore on deletion
  std::vector<std::vector<int64_t>> bucket(m);
  auto pri_of = [&](int64_t j) -> double {
    const double c = chn_pen_gap;
    switch (pri_mode) {
      case 0: return (double)f[j] + 0.5 * c * ((double)ax[j] + (double)ay[j]);
      case 1: return (double)f[j] + c * (double)ay[j];
      default: return (double)f[j];
    }
  };
  auto bucket_refresh = [&](int32_t leaf) {
    double best = NEG;
    int64_t arg = -1;
    for (int64_t j : bucket[leaf]) {
      const double pr = pri_of(j);
      if (pr > best) { best = pr; arg = j; }
    }
    seg_set(leaf, best, arg);
  };
  auto tree_insert = [&](int64_t j) {
    const int32_t leaf = yleaf(ay[j]);
    bucket[leaf].push_back(j);
    const double pr = pri_of(j);
    if (pr > seg[leaf + size]) seg_set(leaf, pr, j);
  };
  auto tree_delete = [&](int64_t j) {
    const int32_t leaf = yleaf(ay[j]);
    auto &b = bucket[leaf];
    for (size_t z = 0; z < b.size(); z++)
      if (b[z] == j) { b[z] = b.back(); b.pop_back(); break; }
    bucket_refresh(leaf);
  };
  // inner active set ordered by (y, idx) for descending-y iteration
  std::set<std::pair<int32_t, int64_t>> inner;
  std::vector<int64_t> t(n, -1);

  auto comput_sc = [&](int64_t i, int64_t j, int32_t *exact,
                       int32_t *width) -> int32_t {
    const int32_t dq = ay[i] - ay[j];
    if ((flags & 1) && dq <= 0) {
      *width = INT32_MAX;
      if (exact) *exact = 0;
      return INT32_MIN / 2;
    }
    const int64_t dr64 = ax[i] - ax[j];
    const int32_t dr = (int32_t)dr64;
    const int32_t dd = dr > dq ? dr - dq : dq - dr;
    const int32_t dg = dr < dq ? dr : dq;
    *width = dd;
    int32_t sc = q_span < dg ? q_span : dg;
    if (exact) *exact = (dd == 0 && dg <= q_span);
    if (dd || dg > q_span) {
      const float lin_pen = chn_pen_gap * (float)dd;
      const float log_pen = dd >= 1 ? mg_log2((float)dd + 1.0f) : 0.0f;
      sc -= (int32_t)(lin_pen + 0.5f * log_pen);
    }
    return sc;
  };

  int64_t i0 = 0, st = 0, st_inner = 0;
  int64_t tree_n = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t max_j = -1;
    int32_t max_f = q_span;
    // add anchors with x_j < x_i
    while (i0 < i && ax[i0] < ax[i]) {
      tree_insert(i0);
      inner.insert({ay[i0], i0});
      i0++;
      tree_n++;
    }
    // evict: x-window and size cap
    while (st < i0 && ax[i] - ax[st] > max_dist) {
      tree_delete(st);
      st++;
      tree_n--;
    }
    while (tree_n > cap_rmq_size) {
      tree_delete(st);
      st++;
      tree_n--;
    }
    while (st_inner < i0 && ax[i] - ax[st_inner] > max_dist_inner) {
      inner.erase({ay[st_inner], st_inner});
      st_inner++;
    }
    // outer: single RMQ candidate in y-window [y_i - max_dist, y_i]
    int32_t exact = 0;
    {
      const int32_t win_lo = (flags & 4) ? ay[i] - max_dist + 1 : ay[i] - max_dist;
      const int32_t lo = ylower(win_lo), hi = yupper(ay[i]);
      if (lo <= hi) {
        const int64_t j = seg_query(lo, hi);
        if (j >= 0) {
          int32_t width;
          const int32_t sc = f[j] + comput_sc(i, j, &exact, &width);
          if (width <= bw && sc > max_f) {
            max_f = sc;
            max_j = j;
          } else {
            exact = 0;
          }
        }
      }
    }
    // inner: serial scan with the DP skip heuristic. Default order is
    // descending y (round-3 fixture-calibrated); flag 8 switches to
    // descending INDEX (x-major, mg_chain_dp's loop order) -- the
    // candidate skip-order mechanism behind the junk-pair residue
    // (tools/mm2_junk_residue_experiment.py measures both).
    if (max_dist_inner > 0 && ((flags & 2) || max_j < 0 || !exact)) {
      int32_t n_skip = 0;
      if (flags & 8) {
        for (int64_t j = i0 - 1; j >= st_inner; --j) {
          const int32_t yj = ay[j];
          if (yj >= ay[i] || yj < ay[i] - max_dist) continue;
          int32_t width;
          const int32_t sc = f[j] + comput_sc(i, j, nullptr, &width);
          if (width <= bw) {
            if (sc > max_f) {
              max_f = sc;
              max_j = j;
              if (n_skip > 0) n_skip--;
            } else if (t[j] == i) {
              if (++n_skip > max_skip) break;
            }
            if (p[j] >= 0) t[p[j]] = i;
          }
        }
      } else {
        auto it = inner.upper_bound({ay[i], i});
        while (it != inner.begin()) {
          --it;
          const int32_t yj = it->first;
          if (yj < ay[i] - max_dist) break;
          const int64_t j = it->second;
          int32_t width;
          const int32_t sc = f[j] + comput_sc(i, j, nullptr, &width);
          if (width <= bw) {
            if (sc > max_f) {
              max_f = sc;
              max_j = j;
              if (n_skip > 0) n_skip--;
            } else if (t[j] == i) {
              if (++n_skip > max_skip) break;
            }
            if (p[j] >= 0) t[p[j]] = i;
          }
        }
      }
    }
    f[i] = max_f;
    p[i] = max_j;
  }
}

// mg_chain_backtrack (lchain.c): peaks by descending (f, index); each
// walk truncated where the cumulative score falls more than max_drop
// below its running maximum (mg_chain_bk_end); anchors visited beyond
// the cut are burned (t=2) and join no chain. Emits chains in peak
// order: v = concatenated anchor indices (ascending within a chain),
// chain_off = n_chains+1 offsets into v, chain_sc = scores. Returns
// n_chains.
int64_t mm2_backtrack(const int32_t *f, const int64_t *p, int64_t n,
                      int32_t max_drop, int32_t min_sc, int32_t min_cnt,
                      int64_t *v, int64_t *chain_off, int32_t *chain_sc) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (f[a] != f[b]) return f[a] > f[b];
    return a > b;
  });
  std::vector<int8_t> t(n, 0);
  int64_t n_chains = 0, n_v = 0;
  chain_off[0] = 0;
  for (int64_t oi = 0; oi < n; oi++) {
    const int64_t peak = order[oi];
    const int32_t fpeak = f[peak];
    if (fpeak < min_sc) break;
    if (t[peak]) continue;
    // mg_chain_bk_end
    int64_t i = peak, max_i = peak;
    int32_t max_s = 0;
    while (true) {
      t[i] = 2;
      i = p[i];
      const int32_t s = i < 0 ? fpeak : fpeak - f[i];
      if (s > max_s) {
        max_s = s;
        max_i = i;
      } else if (max_s - s > max_drop) {
        break;
      }
      if (i < 0 || t[i] != 0) break;
    }
    const int64_t end_i = max_i;
    const int64_t v0 = n_v;
    for (i = peak; i != end_i; i = p[i]) {
      v[n_v++] = i;
      t[i] = 1;
    }
    const int32_t sc = end_i < 0 ? fpeak : fpeak - f[end_i];
    if (n_v > v0 && sc >= min_sc && n_v - v0 >= min_cnt) {
      // reverse to ascending anchor order
      for (int64_t a = v0, b = n_v - 1; a < b; a++, b--) {
        const int64_t tmp = v[a];
        v[a] = v[b];
        v[b] = tmp;
      }
      chain_sc[n_chains] = sc;
      chain_off[++n_chains] = n_v;
    } else {
      n_v = v0;
    }
  }
  return n_chains;
}

void mm2_chain_rmq2(const int64_t *ax, const int32_t *ay, int64_t n,
                    int32_t q_span, int32_t max_dist, int32_t max_dist_inner,
                    int32_t bw, int32_t max_skip, int32_t cap_rmq_size,
                    float chn_pen_gap, int32_t pri_mode, int32_t *f,
                    int64_t *p) {
  mm2_chain_rmq2_f(ax, ay, n, q_span, max_dist, max_dist_inner, bw, max_skip,
                   cap_rmq_size, chn_pen_gap, pri_mode, 0, f, p);
}

}  // extern "C"
