// Batched affine-gap Smith-Waterman for ANIb: best local score and its
// cell, one warp per (fragment, window) task.
//
// Replaces the Pallas TPU kernel pyani_plus_tpu/ops/sw_pallas.py
// (_make_kernel, score only) and the XLA scan it stood beside,
// pyani_plus_tpu/ops/dp_jax.py (_get_best_kernel): per task it returns
// (score, best_i, best_j), the score being the host kernel's
// (pyani_plus_tpu/native/align.cpp, local_align_score) and the cell the
// host stats DP's (first maximum in row-major order, 1-based; (0, 0)
// when no cell scores above 0). blastn's scoring (ops/dp.py) is compiled
// in.
//
// Recurrences, row i over columns j (H row 0 and column 0 are 0):
//   F[i][j] = max(H[i-1][j] - go - ge, F[i-1][j] - ge)
//   G[i][j] = max(H[i-1][j-1] + sub(q[i-1], s[j-1]), F[i][j], 0)
//   E[i][j] = max_{j' < j}(G[i][j'] + ge*j') - go - ge*j
//   H[i][j] = max(G[i][j], E[i][j])
// A code >= 4 never matches (N == N, IUPAC letters, padding code 5).
//
// Layout: a warp walks the window in stripes of 32 x COLS columns; lane
// L owns columns L*COLS .. L*COLS+COLS-1 of the stripe, with H and F in
// registers. For each stripe the warp runs every fragment row:
//   - the diagonal for a lane's first column is the left lane's last
//     column of the previous row (__shfl_up_sync); lane 0 takes the
//     stripe boundary, kept in a per-task scratch row by the previous
//     stripe (0 for the first stripe, column 0);
//   - F and G are lane-local;
//   - E is an exclusive prefix max of G + ge*j, j counted from the
//     stripe's first column: within a lane first, then a 5-step
//     __shfl_up_sync scan of the lanes' totals in 32-bit words, seeded
//     with the max carried from the stripes to the left (same scratch
//     row, rebased by ge * STRIPE); a lane is handed the scan's value
//     less ge times its own first column;
//   - the best cell: each lane keeps the first maximum of its own cells
//     (strict improvement, rows then columns in order); lanes and
//     stripes merge by (score desc, i asc, j asc), which is the
//     row-major first maximum of the whole matrix. Columns past the
//     window's end hold a code that never matches: such a cell's value
//     comes, through a mismatch or a gap, from a cell before it in
//     row-major order that scores strictly more, so it is never the
//     matrix's maximum and needs no mask.
// Tasks are ragged and of any length: nothing is padded, no shape is
// compiled in, and the scratch is one (H, E-carry) pair per fragment row.
//
// Two widths, chosen per task (so per warp) inside the one launch:
//
// Packed (task_packed), when reward*min(m, n) + ge*(PCOLS-1) <= 32767:
// two columns a 32-bit register, 16 bits each, PCOLS = 24 columns a lane
// in 12 registers, all per-cell arithmetic in the _s16x2 DPX instructions
// (and one packed add). A stripe is 768 columns: ANIb's windows (a
// 1,020-base fragment, its seed band and 300 columns of slack) take two.
//   - The diagonal of register r is __byte_perm(H[r-1], H[r]): the high
//     half of the register before and the low half of this one.
//   - F = max(H - go - ge, F - ge) (__vadd2, then __viaddmax_s16x2): the
//     fill of row 0 is -(go + ge), not
//     a large negative. H >= 0, so any fill <= -go gives F[1] = -(go+ge)
//     exactly, from then on F >= -(go+ge), and nothing wraps.
//   - G = __viaddmax_s16x2_relu(diag, sub, F). The substitution scores
//     are read, not computed: at each stripe a lane writes, for each
//     fragment code 0..3 (and one row of all-penalty for codes >= 4), its
//     12 registers of packed scores into shared memory (a window profile,
//     7.5 KB a warp); a row reads its 12 registers with three 16-byte
//     loads.
//   - E within the lane: P[r] = max(P[r-1], G[r] + ge*c) runs over the
//     registers, so its low half is the max over even columns up to r and
//     its high half over odd ones; the even column 2r takes
//     max(P[r-1].lo, P[r-1].hi, handed), the odd column 2r+1
//     max(P[r].lo, P[r-1].hi, handed), built with two __byte_perm and one
//     __vimax3_s16x2; H = __viaddmax_s16x2(that, -go - ge*c, G).
//   - What a lane is handed is clamped at 0 before it is packed: at or
//     below 0 it gives E < 0 <= G and lifts no cell, and E is recomputed
//     from G in every row, never stored, so the clamp is exact. Above 0
//     it is at most a cell's score. The scan itself, its carry across
//     stripes and the scratch stay 32-bit, so the window's length sets no
//     limit: the largest packed value is a score (at most reward*min(m,
//     n)) plus ge*(PCOLS-1), which is the rule above (blastn: min(m, n)
//     <= 16360; ANIb's fragments have 1,020 rows).
//   - The best cell: a packed max over the lane's registers gives the
//     row's maximum; only when it beats the lane's best so far are the 24
//     cells searched, in column order, for the first that holds it.
// Wide (task_wide): the same row in 32-bit words, WCOLS = 8 columns a
// lane, for every other task.
//
// What bounds it on an H100: integer max-plus arithmetic issued by one
// warp per task, a serial chain of rows per stripe; the bytes read are a
// few per row. wgmma and TMA do not apply. Latency hides across warps
// (at most 80 registers a thread, so 6 warps a scheduler fit) and across
// a lane's independent registers; the next row's fragment code and
// boundary are loaded one row ahead. The per-row work that does not grow
// with the columns (the scan's shuffles, the boundary, the loads) is a
// third of the row, which is why 24 columns a lane beat 16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libsw.so sw.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// blastn's scoring (ops/dp.py), compiled in: the packed constants are
// then immediates, not registers.
constexpr int REWARD = 2;
constexpr int PENALTY = -3;
constexpr int GAP_OPEN = 5;
constexpr int GAP_EXTEND = 2;

constexpr int WARPS_PER_BLOCK = 4;
constexpr int BLOCKS_PER_SM = 6;
constexpr int PCOLS = 24;  // packed path: window columns per lane and stripe
constexpr int PREGS = PCOLS / 2;  // registers of two columns
constexpr int PQUADS = PREGS / 4;  // 16-byte loads of a profile row
static_assert(PCOLS % 8 == 0, "a profile row is read in 16-byte loads of 8 columns");
constexpr int WCOLS = 8;  // 32-bit path
constexpr int32_t NEG = -1000000;  // the carry into a first stripe; the 32-bit path's F fill
constexpr uint32_t NEG2 = 0x80008000u;  // -32768 in both halves
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t S_PAST = 255;  // a window column past its end
constexpr uint32_t PROFILE_ROWS = 5;  // fragment codes 0..3, and any other

__host__ __device__ constexpr uint32_t pack2(int lo, int hi) {
  return ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
}

struct Best {
  int32_t s, i, j;
};

// b is better than a: greater score, or equal score at an earlier cell
// in row-major order.
__device__ __forceinline__ bool better(const Best &b, const Best &a) {
  return b.s > a.s || (b.s == a.s && (b.i < a.i || (b.i == a.i && b.j < a.j)));
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int delta = 16; delta > 0; delta /= 2) {
    const Best o{__shfl_xor_sync(FULL, b.s, delta), __shfl_xor_sync(FULL, b.i, delta),
                 __shfl_xor_sync(FULL, b.j, delta)};
    if (better(o, b)) b = o;
  }
  return b;
}

// The lanes' totals (max of G + ge*j over a lane's columns, j from the
// stripe's first column) and, in lane 0, the carry from the stripes to
// the left: returns what lies left of this lane (lane 0: its carry) and
// sets `through` to the max through this lane, carry included.
__device__ __forceinline__ int32_t scan_lanes(int32_t total, int32_t carry, int lane,
                                              int32_t &through) {
  int32_t incl = lane == 0 ? max(total, carry) : total;
#pragma unroll
  for (int delta = 1; delta < 32; delta *= 2)
    incl = max(incl, __shfl_up_sync(FULL, incl, delta));  // a lane below delta gets its own
  through = incl;
  const int32_t before = __shfl_up_sync(FULL, incl, 1);
  return lane == 0 ? carry : before;
}

// One task in packed 16-bit lanes; `profile` is this lane's column of
// the warp's window profile (rows of 32 uint4, PQUADS rows per code).
__device__ __forceinline__ Best task_packed(const uint8_t *__restrict__ q,
                                            const uint8_t *__restrict__ s, int2 *edge, int m,
                                            int n, uint4 *profile, int lane) {
  constexpr int STRIPE = 32 * PCOLS;
  constexpr uint32_t N_GO_GE = pack2(-GAP_OPEN - GAP_EXTEND, -GAP_OPEN - GAP_EXTEND);
  constexpr uint32_t N_GE = pack2(-GAP_EXTEND, -GAP_EXTEND);
  const int32_t lane_gej = GAP_EXTEND * lane * PCOLS;  // ge * the lane's first column
#pragma unroll
  for (int h = 0; h < PQUADS; h++) {
    constexpr uint32_t w = pack2(PENALTY, PENALTY);
    profile[(4 * PQUADS + h) * 32] = make_uint4(w, w, w, w);
  }

  Best best{0, 0, 0};
  for (int j0 = 0; j0 < n; j0 += STRIPE) {
    const bool first = j0 == 0;
    const bool last = j0 + STRIPE >= n;
    const int k0 = j0 + lane * PCOLS;  // 0-based window index of the lane's first column
    uint32_t code[PCOLS];
#pragma unroll
    for (int c = 0; c < PCOLS; c++) code[c] = k0 + c < n ? s[k0 + c] : S_PAST;
#pragma unroll
    for (uint32_t k = 0; k < 4; k++) {
      uint32_t w[PREGS];
#pragma unroll
      for (int r = 0; r < PREGS; r++)
        w[r] = pack2(code[2 * r] == k ? REWARD : PENALTY, code[2 * r + 1] == k ? REWARD : PENALTY);
#pragma unroll
      for (int h = 0; h < PQUADS; h++)
        profile[(k * PQUADS + h) * 32] =
            make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
    }
    __syncwarp();

    uint32_t H[PREGS], F[PREGS];
#pragma unroll
    for (int r = 0; r < PREGS; r++) {
      H[r] = 0;
      F[r] = N_GO_GE;
    }
    // H[i-1][j0] (the stripe's left boundary, previous row), lane 0 only
    int32_t edge_h_prev = 0;
    Best mine{0, 0, 0};
    // row i's fragment code and boundary, loaded during row i - 1
    uint32_t q_next = q[0];
    int2 e_next = make_int2(0, NEG);
    if (!first && lane == 0) e_next = edge[0];

    for (int i = 1; i <= m; i++) {
      const uint32_t qc = min(q_next, PROFILE_ROWS - 1);
      const int2 e = e_next;  // (H[i][j0], max of G + ge*j left of j0), lane 0
      {
        const int ahead = min(i, m - 1);
        q_next = q[ahead];
        if (!first && lane == 0) e_next = edge[ahead];
      }
      uint32_t sub[PREGS];
#pragma unroll
      for (int h = 0; h < PQUADS; h++) {
        const uint4 v = profile[(qc * PQUADS + h) * 32];
        sub[4 * h] = v.x;
        sub[4 * h + 1] = v.y;
        sub[4 * h + 2] = v.z;
        sub[4 * h + 3] = v.w;
      }
      // only the high half of `left` is read: the left lane's last column
      uint32_t left = __shfl_up_sync(FULL, H[PREGS - 1], 1);
      if (lane == 0) left = (uint32_t)edge_h_prev << 16;

      // F and G from the previous row (H is not written until E is known),
      // and the running max of G + ge*c, even and odd columns apart
      uint32_t G[PREGS], P[PREGS];
      uint32_t run = NEG2;
#pragma unroll
      for (int r = 0; r < PREGS; r++) {
        const uint32_t diag = __byte_perm(r == 0 ? left : H[r - 1], H[r], 0x5432);
        F[r] = __viaddmax_s16x2(H[r], N_GO_GE, __vadd2(F[r], N_GE));
        G[r] = __viaddmax_s16x2_relu(diag, sub[r], F[r]);
        run = __viaddmax_s16x2(G[r], pack2(GAP_EXTEND * 2 * r, GAP_EXTEND * (2 * r + 1)), run);
        P[r] = run;
      }
      // both halves are >= 0
      const int32_t total = (int32_t)max(run & 0xffffu, run >> 16) + lane_gej;
      const int32_t carry = e.y - GAP_EXTEND * STRIPE;  // lane 0's is the one read
      int32_t through;
      const int32_t before = scan_lanes(total, carry, lane, through);
      // in 0 .. the largest score: fits a half
      const uint32_t handed = (uint32_t)max(before - lane_gej, 0) * 0x10001u;

      uint32_t prev = NEG2, row2 = 0;
#pragma unroll
      for (int r = 0; r < PREGS; r++) {
        // low: even columns before this register; high: up to this one
        const uint32_t evens = __byte_perm(prev, P[r], 0x5410);
        const uint32_t odds = __byte_perm(prev, prev, 0x3232);  // before this register
        const uint32_t x = __vimax3_s16x2(evens, odds, handed);
        H[r] = __viaddmax_s16x2(x, pack2(-GAP_OPEN - GAP_EXTEND * 2 * r,
                                         -GAP_OPEN - GAP_EXTEND * (2 * r + 1)), G[r]);
        row2 = __vmaxs2(row2, H[r]);
        prev = P[r];
      }
      const int32_t row_max = (int32_t)max(row2 & 0xffffu, row2 >> 16);
      if (row_max > mine.s) {  // the first of the lane's cells that holds it
        int c_first = 0;
#pragma unroll
        for (int r = PREGS - 1; r >= 0; r--) {
          if ((int32_t)(H[r] >> 16) == row_max) c_first = 2 * r + 1;
          if ((int32_t)(H[r] & 0xffffu) == row_max) c_first = 2 * r;
        }
        mine = Best{row_max, i, k0 + c_first + 1};
      }

      if (!last) {  // the next stripe's boundary: H and the E carry at its left
        const int32_t h_end = __shfl_sync(FULL, (int32_t)(H[PREGS - 1] >> 16), 31);
        const int32_t run_end = __shfl_sync(FULL, through, 31);
        if (lane == 0) edge[i - 1] = make_int2(h_end, run_end);
      }
      edge_h_prev = e.x;
    }
    const Best stripe = warp_best(mine);
    if (better(stripe, best)) best = stripe;
  }
  return best;
}

// One task in 32-bit words: the same row, one column a register.
__device__ __forceinline__ Best task_wide(const uint8_t *__restrict__ q,
                                          const uint8_t *__restrict__ s, int2 *edge, int m,
                                          int n, int lane) {
  constexpr int STRIPE = 32 * WCOLS;
  constexpr uint32_t Q_OTHER = 254;  // a fragment code >= 4
  const int32_t lane_gej = GAP_EXTEND * lane * WCOLS;

  Best best{0, 0, 0};
  for (int j0 = 0; j0 < n; j0 += STRIPE) {
    const bool first = j0 == 0;
    const bool last = j0 + STRIPE >= n;
    const int k0 = j0 + lane * WCOLS;
    uint32_t sc[WCOLS];
    int32_t H[WCOLS], F[WCOLS];
#pragma unroll
    for (int c = 0; c < WCOLS; c++) {
      const uint32_t code = k0 + c < n ? s[k0 + c] : S_PAST;
      sc[c] = code < 4 ? code : S_PAST;
      H[c] = 0;
      F[c] = NEG;
    }
    int32_t edge_h_prev = 0;
    Best mine{0, 0, 0};

    for (int i = 1; i <= m; i++) {
      const uint32_t qraw = q[i - 1];
      const uint32_t qc = qraw < 4 ? qraw : Q_OTHER;
      int2 e = make_int2(0, NEG);
      if (!first && lane == 0) e = edge[i - 1];
      int32_t left = __shfl_up_sync(FULL, H[WCOLS - 1], 1);
      if (lane == 0) left = edge_h_prev;

      int32_t G[WCOLS];
      int32_t total = NEG;
#pragma unroll
      for (int c = 0; c < WCOLS; c++) {
        const int32_t diag = (c == 0 ? left : H[c - 1]) + (sc[c] == qc ? REWARD : PENALTY);
        F[c] = __viaddmax_s32(H[c], -GAP_OPEN - GAP_EXTEND, F[c] - GAP_EXTEND);
        G[c] = __vimax3_s32(diag, F[c], 0);
        total = max(total, G[c] + GAP_EXTEND * c);
      }
      const int32_t carry = e.y - GAP_EXTEND * STRIPE;  // lane 0's is the one read
      int32_t through;
      int32_t run = scan_lanes(total + lane_gej, carry, lane, through) - lane_gej;

      int32_t row_max = 0, row_c = 0;
#pragma unroll
      for (int c = 0; c < WCOLS; c++) {
        const int32_t h = max(G[c], run - GAP_OPEN - GAP_EXTEND * c);
        run = max(run, G[c] + GAP_EXTEND * c);
        H[c] = h;
        if (h > row_max) {  // the first maximum of this lane's cells of the row
          row_max = h;
          row_c = c;
        }
      }
      if (row_max > mine.s) mine = Best{row_max, i, k0 + row_c + 1};

      if (!last) {
        const int32_t h_end = __shfl_sync(FULL, H[WCOLS - 1], 31);
        const int32_t run_end = __shfl_sync(FULL, through, 31);
        if (lane == 0) edge[i - 1] = make_int2(h_end, run_end);
      }
      edge_h_prev = e.x;
    }
    const Best stripe = warp_best(mine);
    if (better(stripe, best)) best = stripe;
  }
  return best;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, BLOCKS_PER_SM)
    sw_kernel(const uint8_t *__restrict__ q_all, const uint8_t *__restrict__ s_all,
              const int64_t *__restrict__ q_off, const int64_t *__restrict__ s_off,
              const int32_t *__restrict__ m_len, const int32_t *__restrict__ n_len,
              int ntasks, int2 *__restrict__ scratch, int32_t *__restrict__ out) {
  __shared__ uint4 profiles[WARPS_PER_BLOCK][PROFILE_ROWS * PQUADS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int task = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (task >= ntasks) return;  // the whole warp leaves together
  const uint8_t *q = q_all + q_off[task];
  const uint8_t *s = s_all + s_off[task];
  // scratch row i - 1 holds the stripe boundary of fragment row i
  int2 *edge = scratch + q_off[task];
  const int m = m_len[task];
  const int n = n_len[task];

  Best best{0, 0, 0};
  if (m > 0 && n > 0) {
    // ops/sw.py's uses_packed_lanes: the same rule from the same numbers
    const bool packed = (int64_t)REWARD * min(m, n) + GAP_EXTEND * (PCOLS - 1) <= 32767;
    best = packed ? task_packed(q, s, edge, m, n, &profiles[warp][0][lane], lane)
                  : task_wide(q, s, edge, m, n, lane);
  }
  if (lane == 0) {
    int32_t *o = out + (int64_t)task * 3;
    o[0] = best.s;
    o[1] = best.i;
    o[2] = best.j;
  }
}

}  // namespace

extern "C" {

// out: (ntasks, 3) int32 rows of (score, best_i, best_j); scratch: one
// int2 per fragment byte of q_all. Launches on `stream` and returns
// cudaGetLastError().
int sw_launch(const void *q_all, const void *s_all, const void *q_off, const void *s_off,
              const void *m_len, const void *n_len, int ntasks, void *scratch, void *out,
              void *stream) {
  if (ntasks <= 0) return 0;
  const int blocks = (ntasks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  sw_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)q_all, (const uint8_t *)s_all, (const int64_t *)q_off,
      (const int64_t *)s_off, (const int32_t *)m_len, (const int32_t *)n_len, ntasks,
      (int2 *)scratch, (int32_t *)out);
  return (int)cudaGetLastError();
}

const char *sw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
