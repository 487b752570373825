// Batched free-end banded Gotoh extensions for ANIm, one warp per task.
//
// Replaces the Pallas TPU kernel pyani_plus_tpu/ops/extend_pallas.py
// (_make_kernel) and computes exactly what the host oracle computes
// (native/band.cpp, band_affine with free_end = 1): band +-60 around the
// unit diagonal (121 live columns), affine gaps, every state carrying
// (score, errors, nonid, gap columns), the best cell with the
// longer-extension tie rule, and the give-up rule after stop_rows rows
// without improvement.
//
// What bounds it on an H100: a task is a serial chain of up to ~10^4
// dependent rows and a launch lasts as long as its longest task, so the
// time is that of one row for one warp: the instructions the warp must
// issue for its four columns (about 300) and the latencies in their
// dependence chain (five shuffles for the scan of I, a reduction for the
// best cell), not bytes or FLOPs. wgmma and TMA do not apply (integer
// max-plus, no product; one byte of each sequence per row). On the card,
// every instruction taken out of the row shortened it, and trading
// instructions for a shorter chain (a radix-4 scan, a prefix tree within
// the lane, reading the reduction a row late, unrolling two rows) made
// it longer; the design therefore spends its effort on fewer
// instructions a row:
//
// - Two states a column instead of three. Row i needs of row i-1 only
//   cell = best3(M, D, I) (the diagonal predecessor of M, and the source
//   a vertical gap opens from) and D. Opening D from cell instead of
//   max(M, I) is exact as long as extending a gap costs no more than
//   opening one: where cell is D itself, continuing D beats opening
//   from it, and otherwise cell == max(M, I) with the same tie order
//   (M >= D >= I). M and I live only inside a row.
// - No liveness tests. Every cell inside the band and the matrix can be
//   reached from the origin, so a column is dead exactly when it lies
//   outside them: one unsigned compare against the row's column range
//   resets it, and a dead score plus a few gap costs stays far below
//   every live one.
// - Codes off the chain. Each lane stages one byte of a and one of b for
//   the next 32 rows in a register (one coalesced load per 32 rows, a
//   block ahead); a row takes both with one shuffle. The lane's four b
//   codes sit in one 32-bit window that slides by a byte per row.
// - Packed payloads. Where m + n < 65,536 (every ANIm task), errors and
//   nonid share one word as 16-bit fields and all fields of a state move
//   by one add, so a state is 3 words; a longer task takes the same code
//   with 32-bit fields (template parameter, chosen per task, the same
//   for the whole warp).
// - A one-word scan for I. The horizontal state is a prefix maximum of
//   key = base + open - extend * (k + 1), latest source on ties. The key
//   and its source column are packed as key * 128 + k (a plain max then
//   keeps the latest source), each lane reduces its four columns, five
//   shuffle-and-max steps scan the lanes, and the payload of the winning
//   source is fetched from its lane by two indexed shuffles (the winner
//   before a lane is always the aggregate of the lane that owns it):
//   8 shuffles a row where a scan of four-word elements took 24.
// - One reduction for the best cell. score * 128 + k over the row gives
//   the row maximum and its largest column in one __reduce_max_sync;
//   the best cell's payload stays in the lane that owns it and is
//   fetched once, after the last row.
// - Longest tasks first: the wrapper sorts the batch so that the long
//   chains start at once and short tasks fill in behind them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libextend.so extend.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 60;
constexpr int WIDTH = 2 * BAND + 1;  // 121 live band columns
constexpr int COLS = 4;              // band columns per lane
constexpr int WARPS_PER_BLOCK = 1;
constexpr unsigned FULL = 0xffffffffu;
// Packed payloads hold errors, nonid and gap columns (each <= m + n) in
// 16-bit fields and score * 128 + column in 32 bits.
constexpr long long PACK_LIMIT = 65535;

struct PayPacked {
  uint32_t en;  // errors | nonid << 16
  uint32_t g;   // gap columns
};
struct PayWide {
  int32_t e, n, g;
};

template <bool PACKED> struct Traits;
template <> struct Traits<true> {
  using Key = int32_t;
  using Pay = PayPacked;
  // |live score| <= 13 + 7 * 65,535 < 2^19, so dead is far below it and
  // dead * 128 still fits in 32 bits.
  static constexpr int32_t NEG = -(1 << 22);
};
template <> struct Traits<false> {
  using Key = long long;
  using Pay = PayWide;
  static constexpr int32_t NEG = -1000000000;
};

__device__ __forceinline__ PayPacked zero_pay(PayPacked) { return PayPacked{0u, 0u}; }
__device__ __forceinline__ PayWide zero_pay(PayWide) { return PayWide{0, 0, 0}; }

// Add d to errors, nonid and gap columns (d may be negative: the packed
// fields wrap mod 2^32 and come out exact once the sum is in range).
__device__ __forceinline__ PayPacked shift_pay(PayPacked p, int d) {
  return PayPacked{p.en + (uint32_t)d * 0x10001u, p.g + (uint32_t)d};
}
__device__ __forceinline__ PayWide shift_pay(PayWide p, int d) {
  return PayWide{p.e + d, p.n + d, p.g + d};
}

// A substitution column: an error unless an exact A/C/G/T match, a
// non-identity unless the letters are equal.
__device__ __forceinline__ PayPacked subst_pay(PayPacked p, bool sub_ok, bool same) {
  p.en += sub_ok ? 0u : (same ? 1u : 0x10001u);
  return p;
}
__device__ __forceinline__ PayWide subst_pay(PayWide p, bool sub_ok, bool same) {
  p.e += sub_ok ? 0 : 1;
  p.n += same ? 0 : 1;
  return p;
}

__device__ __forceinline__ PayPacked sel_pay(bool c, PayPacked x, PayPacked y) {
  return PayPacked{c ? x.en : y.en, c ? x.g : y.g};
}
__device__ __forceinline__ PayWide sel_pay(bool c, PayWide x, PayWide y) {
  return PayWide{c ? x.e : y.e, c ? x.n : y.n, c ? x.g : y.g};
}

__device__ __forceinline__ PayPacked shfl_pay(PayPacked p, int src) {
  return PayPacked{__shfl_sync(FULL, p.en, src), __shfl_sync(FULL, p.g, src)};
}
__device__ __forceinline__ PayWide shfl_pay(PayWide p, int src) {
  return PayWide{__shfl_sync(FULL, p.e, src), __shfl_sync(FULL, p.n, src),
                 __shfl_sync(FULL, p.g, src)};
}
__device__ __forceinline__ PayPacked shfl_down_pay(PayPacked p) {
  return PayPacked{__shfl_down_sync(FULL, p.en, 1), __shfl_down_sync(FULL, p.g, 1)};
}
__device__ __forceinline__ PayWide shfl_down_pay(PayWide p) {
  return PayWide{__shfl_down_sync(FULL, p.e, 1), __shfl_down_sync(FULL, p.n, 1),
                 __shfl_down_sync(FULL, p.g, 1)};
}

__device__ __forceinline__ void store_pay(PayPacked p, int32_t *o) {
  o[2] = (int32_t)(p.en & 0xffffu);
  o[3] = (int32_t)(p.en >> 16);
  o[4] = (int32_t)p.g;
}
__device__ __forceinline__ void store_pay(PayWide p, int32_t *o) {
  o[2] = p.e;
  o[3] = p.n;
  o[4] = p.g;
}

template <bool PACKED>
__device__ __forceinline__ void run_task(const uint8_t *__restrict__ a,
                                         const uint8_t *__restrict__ b, const int m,
                                         const int n, const int stop_rows,
                                         const int match, const int mismatch,
                                         const int gap_open, const int gap_extend,
                                         int32_t *__restrict__ o) {
  using T = Traits<PACKED>;
  using Key = typename T::Key;
  using Pay = typename T::Pay;
  constexpr int32_t NEG = T::NEG;
  const Key KEY_DEAD = (Key)NEG * 128;

  const int lane = threadIdx.x & 31;
  const int k0 = lane * COLS;

  // Row 0: the origin at j == 0, horizontal runs to its right; D dead.
  int32_t cs[COLS], ds[COLS];
  Pay cp[COLS], dp[COLS];
#pragma unroll
  for (int c = 0; c < COLS; c++) {
    const int k = k0 + c;
    const int j = k - BAND;
    cs[c] = NEG;
    cp[c] = zero_pay(Pay{});
    if (k < WIDTH && j == 0) cs[c] = 0;
    if (k < WIDTH && j >= 1 && j <= n) {
      cs[c] = gap_open + gap_extend * (j - 1);
      cp[c] = shift_pay(cp[c], j);
    }
    ds[c] = NEG;
    dp[c] = zero_pay(Pay{});
  }

  // The lane's four b codes, a byte each: column k of row i reads
  // b[k + i - BAND - 1]. The window holds row 0's and slides at each row.
  uint32_t window = 0;
#pragma unroll
  for (int c = 0; c < COLS; c++) {
    const int idx = k0 + c - BAND - 1;
    const uint32_t code = (idx >= 0 && idx < n) ? b[idx] : 255u;
    window |= code << (8 * c);
  }
  // Staged codes of 32 rows: lane r holds a[base + r] and, for the top
  // of the last lane's window, b[base + r + 67], as a | b << 8.
  auto load_stage = [&](int base) -> uint32_t {
    const int ia = base + lane;
    const int ib = base + lane + (4 * 32 - 1 - BAND);
    const uint32_t av = ia < m ? a[ia] : 255u;
    const uint32_t bv = ib < n ? b[ib] : 255u;
    return av | (bv << 8);
  };
  uint32_t stage_cur = 0;
  uint32_t stage_next = load_stage(0);

  // Row 0 never improves on the empty extension (score 0 at the origin).
  int32_t best_i = 0, best_j = 0, best_s = 0;
  int best_k = BAND;
  Pay best_pay = zero_pay(Pay{});
  int rows_since = 0;

  for (int i = 1; i <= m; i++) {
    const int r = (i - 1) & 31;
    if (r == 0) {
      stage_cur = stage_next;
      stage_next = load_stage(i - 1 + 32);
    }
    const uint32_t staged = __shfl_sync(FULL, stage_cur, r);
    const uint32_t ac = staged & 0xffu;
    const uint32_t acm = ac < 4u ? ac : 256u;  // a code >= 4 never matches
    const uint32_t below = __shfl_down_sync(FULL, window, 1) & 0xffu;
    window = (window >> 8) | ((lane == 31 ? (staged >> 8) : below) << 24);
    const int jbase = i - BAND;
    // column k is inside the matrix for lo <= k <= hi (j = k + i - BAND
    // in [0, n], k < WIDTH); one unsigned compare each
    const int lo = max(0, BAND - i);
    const unsigned span = (unsigned)(min(WIDTH - 1, n + BAND - i) - lo);

    // Column k+1 of the previous row, for D at the lane's last column.
    int32_t cs_next = __shfl_down_sync(FULL, cs[0], 1);
    int32_t ds_next = __shfl_down_sync(FULL, ds[0], 1);
    const Pay cp_next = shfl_down_pay(cp[0]);
    const Pay dp_next = shfl_down_pay(dp[0]);
    if (lane == 31) cs_next = ds_next = NEG;

    int32_t bs[COLS], nds[COLS];
    Pay bp[COLS], ndp[COLS], rel[COLS];
    Key v[COLS];
    bool valid1[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      const int k = k0 + c;
      const bool valid = (unsigned)(k - lo) <= span;
      valid1[c] = valid && k + jbase >= 1;
      // --- M: diagonal predecessor is the same column of the previous row
      const uint32_t bc = (window >> (8 * c)) & 0xffu;
      const bool sub_ok = bc == acm;
      const bool same = bc == ac;
      const int32_t ms = valid1[c] ? cs[c] + (sub_ok ? match : mismatch) : NEG;
      const Pay mp = subst_pay(cp[c], sub_ok, same);
      // --- D: vertical predecessor is column k+1 of the previous row;
      // continue from D on ties
      const int32_t uo_s = c + 1 < COLS ? cs[c + 1] : cs_next;
      const int32_t ud_s = c + 1 < COLS ? ds[c + 1] : ds_next;
      const Pay uo_p = c + 1 < COLS ? cp[c + 1] : cp_next;
      const Pay ud_p = c + 1 < COLS ? dp[c + 1] : dp_next;
      const int32_t open_s = uo_s + gap_open;
      const int32_t cont_s = ud_s + gap_extend;
      const bool take_cont = cont_s >= open_s;
      int32_t d_s = take_cont ? cont_s : open_s;
      d_s = valid ? d_s : NEG;
      nds[c] = d_s;
      ndp[c] = shift_pay(sel_pay(take_cont, ud_p, uo_p), 1);
      // --- base = max(M, D), M on ties: the source of horizontal runs
      const bool take_d = d_s > ms;
      bs[c] = take_d ? d_s : ms;
      bp[c] = sel_pay(take_d, ndp[c], mp);
      // scan element: key and source column in one word; payloads are
      // kept relative to the source column
      const int32_t key = bs[c] + gap_open - gap_extend * (k + 1);
      v[c] = (Key)key * 128 + k;
      rel[c] = shift_pay(bp[c], -k);
    }

    // --- I: exclusive prefix maximum of the keys, latest source on ties
    Key agg = v[0];
    Pay agg_pay = rel[0];
#pragma unroll
    for (int c = 1; c < COLS; c++) {
      const bool later = v[c] > agg;
      agg = later ? v[c] : agg;
      agg_pay = sel_pay(later, rel[c], agg_pay);
    }
    Key scan = agg;
#pragma unroll
    for (int delta = 1; delta < 32; delta *= 2) {
      const Key left = __shfl_up_sync(FULL, scan, delta);
      if (lane >= delta) scan = left > scan ? left : scan;
    }
    Key run = __shfl_up_sync(FULL, scan, 1);
    if (lane == 0) run = KEY_DEAD;
    // the winner before this lane is the aggregate of the lane owning it
    Pay run_pay = shfl_pay(agg_pay, ((int)(run & 127)) >> 2);

    Key row_key = KEY_DEAD;
    int32_t row_max = NEG;
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      const int k = k0 + c;
      const Key left = run;
      const Pay left_pay = run_pay;
      const bool later = v[c] > run;
      run = later ? v[c] : run;
      run_pay = sel_pay(later, rel[c], run_pay);
      const int32_t left_key = (int32_t)(left >> 7);
      const int32_t is = valid1[c] ? left_key + gap_extend * k : NEG;
      // cell = best3(M, D, I): I only when strictly greater
      const bool take_i = is > bs[c];
      cs[c] = take_i ? is : bs[c];
      cp[c] = sel_pay(take_i, shift_pay(left_pay, k), bp[c]);
      ds[c] = nds[c];
      dp[c] = ndp[c];
      if constexpr (PACKED) {
        const Key ck = (Key)cs[c] * 128 + k;
        row_key = ck > row_key ? ck : row_key;
      } else {
        row_max = max(row_max, cs[c]);
      }
    }

    // --- best cell: the row maximum at its largest column; an update on
    // a greater score, or an equal score with larger i + j
    int32_t rmax;
    int kmax;
    if constexpr (PACKED) {
      const int32_t rk = __reduce_max_sync(FULL, (int32_t)row_key);
      rmax = rk >> 7;
      kmax = rk & 127;
    } else {
      rmax = __reduce_max_sync(FULL, row_max);
      int kc = -1;
#pragma unroll
      for (int c = 0; c < COLS; c++) {
        if (cs[c] == rmax) kc = k0 + c;
      }
      kmax = __reduce_max_sync(FULL, kc);
    }
    const int32_t jbest = kmax + jbase;
    const bool upd = rmax > best_s || (rmax == best_s && i + jbest > best_i + best_j);
    if (upd) {
      best_i = i;
      best_j = jbest;
      best_s = rmax;
      best_k = kmax;
      if (lane == (kmax >> 2)) {
#pragma unroll
        for (int c = 0; c < COLS; c++) {
          if ((kmax & 3) == c) best_pay = cp[c];
        }
      }
      rows_since = 0;
    } else if (stop_rows > 0 && ++rows_since >= stop_rows) {
      break;
    }
  }

  const Pay out_pay = shfl_pay(best_pay, best_k >> 2);
  if (lane == 0) {
    o[0] = best_i;
    o[1] = best_j;
    store_pay(out_pay, o);
  }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    extend_kernel(const uint8_t *__restrict__ a_all, const uint8_t *__restrict__ b_all,
                  const int64_t *__restrict__ a_off, const int64_t *__restrict__ b_off,
                  const int32_t *__restrict__ m_len, const int32_t *__restrict__ n_len,
                  int ntasks, int stop_rows, int match, int mismatch, int gap_open,
                  int gap_extend, int32_t *__restrict__ out) {
  const int task = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (task >= ntasks) return;  // the whole warp leaves together
  const uint8_t *a = a_all + a_off[task];
  const uint8_t *b = b_all + b_off[task];
  const int m = m_len[task];
  const int n = n_len[task];
  int32_t *o = out + (int64_t)task * 5;
  if ((long long)m + (long long)n <= PACK_LIMIT) {
    run_task<true>(a, b, m, n, stop_rows, match, mismatch, gap_open, gap_extend, o);
  } else {
    run_task<false>(a, b, m, n, stop_rows, match, mismatch, gap_open, gap_extend, o);
  }
}

}  // namespace

extern "C" {

// out: (ntasks, 5) int32 rows of (a_advance, b_advance, errors, nonid,
// gap_columns). Launches on `stream` and returns cudaGetLastError().
int extend_launch(const void *a_all, const void *b_all, const void *a_off,
                  const void *b_off, const void *m_len, const void *n_len, int ntasks,
                  int stop_rows, int match, int mismatch, int gap_open, int gap_extend,
                  void *out, void *stream) {
  if (ntasks <= 0) return 0;
  const int blocks = (ntasks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  extend_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_all, (const uint8_t *)b_all, (const int64_t *)a_off,
      (const int64_t *)b_off, (const int32_t *)m_len, (const int32_t *)n_len, ntasks,
      stop_rows, match, mismatch, gap_open, gap_extend, (int32_t *)out);
  return (int)cudaGetLastError();
}

const char *extend_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
