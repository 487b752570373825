// Native affine-gap local alignment with statistics (host hot path).
//
// Bit-identical to pyani_plus_tpu/ops/dp.py's local_align_stats: same
// recurrence (E derived from G = max(0, diag, F), exploiting that chained
// same-direction gaps are never optimal under affine costs), same argmax
// cell choice (first maximum in row-major order), same traceback
// preferences (diagonal > E > F on ties, shortest gap length).
//
// Layout: the row fill is split into a vectorisable pass (F/G/diag depend
// only on the previous row, so gcc auto-vectorises them 16-wide with
// AVX-512) and a short serial pass for the within-row E chain. The stats
// kernel resolves every traceback decision AT FILL TIME into a per-cell
// case byte (0 stop, 1 diagonal, 2 horizontal gap, 3 vertical gap) plus
// a gap-origin index, so the traceback needs no value matrices at all:
// the tie rules (diagonal > E > F; shortest gap = latest origin on
// running-max ties) are applied to the exact same comparisons the
// matrix-walk in ops/dp.py performs, which the fuzz parity tests pin.
//
// Used by the ANIb method for per-fragment best-HSP statistics once the
// batched device DP has picked the winning window.
//
// Build: g++ -O3 -march=native -shared -fPIC align.cpp -o libalign.so

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {
constexpr int32_t NEG = -1000000;
constexpr int KEY_SHIFT = 24;  // low bits hold the column (origin) index

// Reused per-thread scratch: the stats DP touches ~5 MB of case/origin
// cells per fragment; reallocating (and page-faulting) that per call
// dominated the old full-matrix kernel's runtime.
struct Scratch {
  std::vector<int32_t> h_prev, f_prev, g_row, d_row, f_row, s32;
  std::vector<int32_t> e_row, eo_row;
  std::vector<int64_t> keys;
  std::vector<uint8_t> cases;
  std::vector<int32_t> origin, forig;
};
thread_local Scratch scratch;

// The case/origin planes cost ~5 bytes/cell; a typical ANIb fragment is
// ~1020 x ~1400 (~7 MB), but the host fallback for oversized windows
// (> MAX_DEVICE_WINDOW lanes) can momentarily need hundreds of MB. Keep
// thread_local reuse for the common shapes, but release (swap-to-empty)
// anything above this cap after use so pool threads don't pin their
// high-water mark for the process lifetime.
constexpr int64_t PLANE_KEEP_CELLS = 16 * 1024 * 1024;  // ~80 MB of planes

void release_oversized_planes() {
  if ((int64_t)scratch.cases.capacity() > PLANE_KEEP_CELLS) {
    std::vector<uint8_t>().swap(scratch.cases);
    std::vector<int32_t>().swap(scratch.origin);
  }
}

// Within-row E chain with origins: e_row[j] (j >= 2) is the best
// gap-open value max_{j'<j}(g[j'] - go - ge*(j-j')) and eo_row[j] the
// LARGEST j' achieving it (shortest-gap tie rule). Equivalent to a
// prefix max over keys (a[j'] << KEY_SHIFT) | j' with a = g + ge*j'
// (j' in the low bits makes the later column win value ties exactly);
// AVX-512 computes it as an in-register log-step inclusive scan, the
// scalar recurrence is the fallback and the semantics oracle.
//
// Templated on the value type: the int16 instantiation clamps outputs
// at NEGV (-8000). The clamp is DECISION-neutral: g >= 0 always in
// this DP, so h = max(g, e) >= 0 and the h == e case test can only
// fire at e >= 0 -- any value below zero (clamped or not) never
// changes a traceback decision; it only prevents int16 underflow.
template <typename VT>
void _e_chain_pass_t(const VT *__restrict__ g_row, VT *__restrict__ e_row,
                     int32_t *__restrict__ eo_row, int64_t n, int32_t go_ge,
                     int32_t ge, int32_t gap_open, VT negv) {
  if (n < 1) return;
  e_row[1] = negv;
  eo_row[1] = 0;
#if defined(__AVX512F__)
  if (n < ((int64_t)1 << KEY_SHIFT)) {
    std::vector<int64_t> &buf = scratch.keys;
    if ((int64_t)buf.size() < n + 1) buf.resize(n + 1);
    int64_t *__restrict__ key = buf.data();
    for (int64_t j = 1; j <= n; j++)
      key[j] = (((int64_t)g_row[j] + (int64_t)ge * j) << KEY_SHIFT) | j;
    const __m512i vmin = _mm512_set1_epi64(INT64_MIN);
    const __m512i last = _mm512_set1_epi64(7);
    __m512i carry = vmin;
    int64_t j = 1;
    for (; j + 7 <= n; j += 8) {
      __m512i v = _mm512_loadu_si512((const void *)(key + j));
      v = _mm512_max_epi64(v, _mm512_alignr_epi64(v, vmin, 7));
      v = _mm512_max_epi64(v, _mm512_alignr_epi64(v, vmin, 6));
      v = _mm512_max_epi64(v, _mm512_alignr_epi64(v, vmin, 4));
      v = _mm512_max_epi64(v, carry);
      _mm512_storeu_si512((void *)(key + j), v);
      carry = _mm512_permutexvar_epi64(last, v);
    }
    int64_t run = j > 1 ? key[j - 1] : INT64_MIN;
    for (; j <= n; j++) {
      const int64_t k = key[j];
      key[j] = k > run ? k : run;
      run = key[j];
    }
    const int64_t mask = ((int64_t)1 << KEY_SHIFT) - 1;
    for (int64_t t = 2; t <= n; t++) {
      const int64_t p = key[t - 1];
      const int64_t val =
          (p >> KEY_SHIFT) - gap_open - (int64_t)ge * t;
      e_row[t] = (VT)(val < (int64_t)negv ? (int64_t)negv : val);
      eo_row[t] = (int32_t)(p & mask);
    }
    return;
  }
#endif
  VT e_run = negv;
  int32_t e_orig = 0;
  for (int64_t j = 1; j <= n; j++) {
    e_row[j] = e_run;
    eo_row[j] = e_orig;
    const int32_t cand = (int32_t)g_row[j] - go_ge;
    int32_t decayed = (int32_t)e_run - ge;
    if (decayed < (int32_t)negv) decayed = negv;  // int16-safe decay
    const bool re = cand >= decayed;
    e_run = (VT)(re ? cand : decayed);
    e_orig = re ? (int32_t)j : e_orig;
  }
}

// Per-type scratch for the stats fill value rows.
template <typename VT>
struct VScratch {
  std::vector<VT> h_prev, f_prev, g_row, d_row, e_row;
};
template <typename VT>
VScratch<VT> &vscratch() {
  static thread_local VScratch<VT> sc;
  return sc;
}

// Stats DP implementation, templated on the value type. The int16
// instantiation halves the memory footprint of every vectorisable fill
// pass (gcc goes 32-wide instead of 16-wide with AVX-512BW); scores
// fit easily (<= 2*m <= 2^14 for ANIb fragments) and all clamps are
// decision-neutral (see _e_chain_pass_t). Bit-identical outputs to the
// int32 instantiation and the numpy oracle (fuzz-locked).
template <typename VT>
int local_align_stats_impl(const uint8_t *q, int64_t m, const uint8_t *s,
                           int64_t n, int reward, int penalty, int gap_open,
                           int gap_extend, VT negv, int64_t *out) {
  const int32_t go_ge = gap_open + gap_extend;
  const int32_t ge = gap_extend;

  Scratch &sc_ = scratch;
  VScratch<VT> &vs = vscratch<VT>();
  vs.h_prev.assign(n + 1, 0);
  vs.f_prev.assign(n + 1, negv);
  vs.g_row.resize(n + 1);
  vs.d_row.resize(n + 1);
  vs.e_row.resize(n + 1);
  sc_.eo_row.resize(n + 1);
  sc_.s32.resize(n);
  const int64_t stride = n + 1;
  if ((int64_t)sc_.cases.size() < (m + 1) * stride) {
    sc_.cases.resize((m + 1) * stride);
    sc_.origin.resize((m + 1) * stride);
  }
  sc_.forig.assign(n + 1, 0);

  VT *__restrict__ h_prev = vs.h_prev.data();
  VT *__restrict__ f_prev = vs.f_prev.data();
  VT *__restrict__ g_row = vs.g_row.data();
  VT *__restrict__ d_row = vs.d_row.data();
  VT *__restrict__ e_row = vs.e_row.data();
  int32_t *__restrict__ eo_row = sc_.eo_row.data();
  int32_t *__restrict__ s32 = sc_.s32.data();
  uint8_t *__restrict__ cases = sc_.cases.data();
  int32_t *__restrict__ origin = sc_.origin.data();
  int32_t *__restrict__ forig = sc_.forig.data();
  for (int64_t j = 0; j < n; j++) s32[j] = (s[j] < 4) ? (int32_t)s[j] : -1;

  int32_t best_score = 0;
  int64_t best_i = 0, best_j = 0;

  for (int64_t i = 1; i <= m; i++) {
    const uint8_t qraw = q[i - 1];
    const int32_t qc = (qraw < 4) ? (int32_t)qraw : -2;  // never == s32
    uint8_t *__restrict__ case_row = &cases[i * stride];
    int32_t *__restrict__ orig_row = &origin[i * stride];
    const int32_t iprev = (int32_t)(i - 1);
    // Pass 1 (vectorisable): everything that depends only on row i-1.
    // f_prev/forig update in place (read-then-write at the same j).
    // h_prev >= 0 always, so f >= -go_ge after the first row; only the
    // initial negv rows need the widening max to stay in range.
#pragma GCC ivdep
    for (int64_t j = 1; j <= n; j++) {
      const VT sub = (VT)((s32[j - 1] == qc) ? reward : penalty);
      const VT diag = (VT)(h_prev[j - 1] + sub);
      const VT f_open = (VT)(h_prev[j] - go_ge);
      VT f_ext = (VT)(f_prev[j] - ge);
      if (f_ext < negv) f_ext = negv;  // int16-safe decay (decision-neutral)
      // shortest-gap rule: reopening (origin i-1) wins ties
      const VT f = (f_open >= f_ext) ? f_open : f_ext;
      forig[j] = (f_open >= f_ext) ? iprev : forig[j];
      f_prev[j] = f;
      VT g = diag > f ? diag : f;
      if (g < 0) g = 0;
      d_row[j] = diag;
      g_row[j] = g;
    }
    // Pass 2: the within-row E chain with its origin (see above).
    _e_chain_pass_t<VT>(g_row, e_row, eo_row, n, go_ge, ge, gap_open, negv);
    // Pass 3 (vectorisable): H + traceback decisions, resolved now:
    // priority diag > E > F, stop at h <= 0 (matches the matrix-walk's
    // `while H > 0` + equality order in ops/dp.py local_align_stats).
#pragma GCC ivdep
    for (int64_t j = 1; j <= n; j++) {
      const VT g = g_row[j];
      const VT e = e_row[j];
      const VT h = g > e ? g : e;
      h_prev[j] = h;
      const uint8_t c =
          (h <= 0) ? 0 : (h == d_row[j]) ? 1 : (h == e) ? 2 : 3;
      case_row[j] = c;
      orig_row[j] = (c == 2) ? eo_row[j] : forig[j];
    }
    // First maximum in row-major order: row max (vectorisable), then
    // first index on strict improvement only.
    VT row_best = 0;
    for (int64_t j = 1; j <= n; j++)
      row_best = h_prev[j] > row_best ? h_prev[j] : row_best;
    if ((int32_t)row_best > best_score) {
      best_score = row_best;
      best_i = i;
      for (int64_t j = 1; j <= n; j++)
        if (h_prev[j] == row_best) {
          best_j = j;
          break;
        }
    }
  }
  if (best_score <= 0) {
    release_oversized_planes();
    return 0;
  }

  // Traceback over the case/origin planes only.
  int64_t i = best_i, j = best_j;
  int64_t length = 0, matches = 0, mismatches = 0, gaps = 0, gap_opens = 0;
  while (i > 0 && j > 0) {
    const uint8_t c = cases[i * stride + j];
    if (c == 0) break;
    if (c == 1) {
      length++;
      // blastn counts IDENTITIES by letter equality, so N aligned to N
      // is an identity (pident 100.000 across an N run) even though it
      // SCORES as a penalty; mismatch = non-identical columns only.
      // Ambiguity letters carry their own code (genomes/__init__.py
      // _ENCODE maps W->87, R->82, ...), so W vs R is a mismatch here
      // exactly as blastn's letter equality gives; only letter-equal
      // columns (N==N, W==W) count as identities.
      if (q[i - 1] == s[j - 1])
        matches++;
      else
        mismatches++;
      i--;
      j--;
    } else if (c == 2) {
      const int64_t o = origin[i * stride + j];
      const int64_t len = j - o;
      gap_opens++;
      length += len;
      gaps += len;
      j = o;
    } else {
      const int64_t o = origin[i * stride + j];
      const int64_t len = i - o;
      gap_opens++;
      length += len;
      gaps += len;
      i = o;
    }
  }
  out[0] = best_score;
  out[1] = length;
  out[2] = matches;
  out[3] = mismatches;
  out[4] = gaps;
  out[5] = gap_opens;
  out[6] = i;
  out[7] = best_i;
  out[8] = j;
  out[9] = best_j;
  release_oversized_planes();
  return 1;
}
}  // namespace

extern "C" {

// out[10]: score, length, matches, mismatches, gaps, gap_opens,
//          query_start, query_end, subject_start, subject_end
// returns 1 on success, 0 if no positive-scoring alignment.
int local_align_stats(const uint8_t *q, int64_t m, const uint8_t *s,
                      int64_t n, int reward, int penalty, int gap_open,
                      int gap_extend, int64_t *out) {
  if (m == 0 || n == 0) return 0;
  // int16 fill when every value provably fits: |score| <= reward*m,
  // and per-cell constants stay above the -8000 clamp.
  const int64_t max_abs =
      (int64_t)(reward > -penalty ? reward : -penalty) * (m + 2) +
      gap_open + 4 * gap_extend;
  if (max_abs < 7500 && n < (int64_t)1 << KEY_SHIFT) {
    return local_align_stats_impl<int16_t>(q, m, s, n, reward, penalty,
                                           gap_open, gap_extend,
                                           (int16_t)-8000, out);
  }
  return local_align_stats_impl<int32_t>(q, m, s, n, reward, penalty,
                                         gap_open, gap_extend, NEG, out);
}

// Score-only local alignment (rolling rows, no traceback storage).
int32_t local_align_score(const uint8_t *q, int64_t m, const uint8_t *s,
                          int64_t n, int reward, int penalty, int gap_open,
                          int gap_extend) {
  if (m == 0 || n == 0) return 0;
  const int32_t go_ge = gap_open + gap_extend;
  const int32_t ge = gap_extend;
  Scratch &sc_ = scratch;
  sc_.h_prev.assign(n + 1, 0);
  sc_.f_prev.assign(n + 1, NEG);
  sc_.g_row.resize(n + 1);
  sc_.f_row.resize(n + 1);
  sc_.s32.resize(n);
  int32_t *__restrict__ h_prev = sc_.h_prev.data();
  int32_t *__restrict__ f_prev = sc_.f_prev.data();
  int32_t *__restrict__ g_row = sc_.g_row.data();
  int32_t *__restrict__ f_row = sc_.f_row.data();
  int32_t *__restrict__ s32 = sc_.s32.data();
  for (int64_t j = 0; j < n; j++) s32[j] = (s[j] < 4) ? (int32_t)s[j] : -1;

  int32_t best = 0;
  for (int64_t i = 1; i <= m; i++) {
    const uint8_t qraw = q[i - 1];
    const int32_t qc = (qraw < 4) ? (int32_t)qraw : -2;
    // Pass 1 (vectorisable): G from the previous row only.
    for (int64_t j = 1; j <= n; j++) {
      const int32_t sub = (s32[j - 1] == qc) ? reward : penalty;
      const int32_t diag = h_prev[j - 1] + sub;
      const int32_t f_open = h_prev[j] - go_ge;
      const int32_t f_ext = f_prev[j] - ge;
      const int32_t f = (f_open >= f_ext) ? f_open : f_ext;
      int32_t g = diag > f ? diag : f;
      if (g < 0) g = 0;
      f_row[j] = f;
      g_row[j] = g;
    }
    // Pass 2 (serial): the E chain + row max.
    int32_t e_run = NEG;
    int32_t row_best = 0;
    for (int64_t j = 1; j <= n; j++) {
      const int32_t g = g_row[j];
      const int32_t h = g > e_run ? g : e_run;
      h_prev[j] = h;
      if (h > row_best) row_best = h;
      const int32_t cand = g - go_ge;
      const int32_t carry = e_run - ge;
      e_run = cand > carry ? cand : carry;
    }
    if (row_best > best) best = row_best;
    std::memcpy(f_prev + 1, f_row + 1, n * sizeof(int32_t));
    h_prev[0] = 0;
  }
  return best;
}

}  // extern "C"
