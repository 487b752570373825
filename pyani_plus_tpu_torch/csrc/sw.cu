// Batched affine-gap Smith-Waterman for ANIb: best local score and its
// cell, one warp per (fragment, window) task.
//
// Replaces the Pallas TPU kernel pyani_plus_tpu/ops/sw_pallas.py
// (_make_kernel, score only) and the XLA scan it stood beside,
// pyani_plus_tpu/ops/dp_jax.py (_get_best_kernel): per task it returns
// (score, best_i, best_j), the score being the host kernel's
// (pyani_plus_tpu/native/align.cpp, local_align_score) and the cell the
// host stats DP's (first maximum in row-major order, 1-based; (0, 0)
// when no cell scores above 0). blastn scoring comes from the caller.
//
// Recurrences, row i over columns j (H row 0 and column 0 are 0):
//   F[i][j] = max(H[i-1][j] - go - ge, F[i-1][j] - ge)      (F row 0 NEG)
//   G[i][j] = max(H[i-1][j-1] + sub(q[i-1], s[j-1]), F[i][j], 0)
//   E[i][j] = max_{j' < j}(G[i][j'] + ge*j') - go - ge*j    (NEG fill)
//   H[i][j] = max(G[i][j], E[i][j])
// A code >= 4 never matches (N == N, IUPAC letters, padding code 5).
//
// Layout: a warp walks the window in stripes of 32 x COLS columns; lane
// L owns columns L*COLS+1 .. L*COLS+COLS of the stripe, with H and F in
// registers. For each stripe the warp runs every fragment row:
//   - the diagonal for a lane's first column is the left lane's last
//     column of the previous row (__shfl_up_sync); lane 0 takes the
//     stripe boundary, kept in a per-task scratch row by the previous
//     stripe (0 for the first stripe, column 0);
//   - F and G are lane-local (DPX: __viaddmax_s32, __vimax3_s32);
//   - E is an exclusive prefix max of G + ge*j: serial over a lane's
//     columns, then a 5-step __shfl_up_sync scan, seeded with the max
//     carried from the stripes to the left (same scratch row);
//   - the best cell: each lane keeps the first maximum of its own cells
//     (strict improvement, rows then columns in order); lanes and
//     stripes merge by (score desc, i asc, j asc), which is the
//     row-major first maximum of the whole matrix.
// Tasks are ragged and of any length: nothing is padded, no shape is
// compiled in, and the scratch is one (H, E-carry) pair per fragment row.
//
// What bounds it on an H100: integer max-plus arithmetic, about 20
// instructions per cell, a serial chain of rows per stripe; the bytes
// read are a few per row. wgmma and TMA do not apply. Latency hides
// across warps (one task per warp, 4 warps per block) and across a
// lane's COLS independent columns. int16x2 lanes, several tasks per
// warp and pinned, overlapped copies are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libsw.so sw.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 16;  // window columns per lane and stripe
constexpr int STRIPE = 32 * COLS;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int32_t NEG = -1000000;  // the JAX kernels' E fill and F start
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t Q_OTHER = 254;  // a query code >= 4
constexpr uint32_t S_OTHER = 255;  // a window code >= 4, or past its end

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

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    sw_kernel(const uint8_t *__restrict__ q_all, const uint8_t *__restrict__ s_all,
              const int64_t *__restrict__ q_off, const int64_t *__restrict__ s_off,
              const int32_t *__restrict__ m_len, const int32_t *__restrict__ n_len,
              int ntasks, int reward, int penalty, int gap_open, int gap_extend,
              int2 *__restrict__ scratch, int32_t *__restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (task >= ntasks) return;  // the whole warp leaves together
  const uint8_t *q = q_all + q_off[task];
  const uint8_t *s = s_all + s_off[task];
  // scratch row i - 1 holds the stripe boundary of fragment row i
  int2 *edge = scratch + q_off[task];
  const int m = m_len[task];
  const int n = n_len[task];
  const int32_t go_ge = gap_open + gap_extend;
  const int32_t ge = gap_extend;

  Best best{0, 0, 0};
  for (int j0 = 0; j0 < n; j0 += STRIPE) {
    const bool first = j0 == 0;
    const bool last = j0 + STRIPE >= n;
    // this lane's columns are j0 + k0 + c + 1 (1-based), c < COLS
    const int k0 = j0 + lane * COLS;
    uint32_t sc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      const int j = k0 + c;  // 0-based window index
      const uint32_t code = j < n ? s[j] : S_OTHER;
      sc[c] = code < 4 ? code : S_OTHER;
    }
    int32_t H[COLS], F[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      H[c] = 0;
      F[c] = NEG;
    }
    // H[i-1][j0] (the stripe's left boundary, previous row), lane 0 only
    int32_t edge_h_prev = 0;
    Best mine{0, 0, 0};

    for (int i = 1; i <= m; i++) {
      const uint32_t qraw = q[i - 1];
      const uint32_t qc = qraw < 4 ? qraw : Q_OTHER;
      int32_t edge_h = 0;  // H[i][j0], for the next row
      int32_t carry = NEG;  // max of G + ge*j over the columns left of j0
      if (!first && lane == 0) {
        const int2 e = edge[i - 1];
        edge_h = e.x;
        carry = e.y;
      }
      int32_t left = __shfl_up_sync(FULL, H[COLS - 1], 1);
      if (lane == 0) left = edge_h_prev;

      // F and G from the previous row (H is not written until E is known)
      int32_t G[COLS];
#pragma unroll
      for (int c = 0; c < COLS; c++) {
        const int32_t diag = (c == 0 ? left : H[c - 1]) + (sc[c] == qc ? reward : penalty);
        F[c] = __viaddmax_s32(H[c], -go_ge, F[c] - ge);
        G[c] = __vimax3_s32(diag, F[c], 0);
      }
      const int32_t gej0 = ge * (k0 + 1);  // ge * j at the lane's first column
      int32_t total = G[0] + gej0;
#pragma unroll
      for (int c = 1; c < COLS; c++) total = max(total, G[c] + gej0 + ge * c);

      // warp inclusive max-scan of the lane totals, seeded with the carry
      carry = __shfl_sync(FULL, carry, 0);
      int32_t incl = total;
#pragma unroll
      for (int delta = 1; delta < 32; delta *= 2) {
        const int32_t o = __shfl_up_sync(FULL, incl, delta);
        if (lane >= delta) incl = max(incl, o);
      }
      int32_t run = __shfl_up_sync(FULL, incl, 1);
      run = lane == 0 ? carry : max(run, carry);

      int32_t row_max = 0, row_j = 0;
#pragma unroll
      for (int c = 0; c < COLS; c++) {
        const int32_t gej = gej0 + ge * c;
        const int32_t h = max(G[c], run - gap_open - gej);
        run = max(run, G[c] + gej);
        H[c] = h;
        // first maximum of this lane's cells of the row, real columns only
        if (h > row_max && k0 + c < n) {
          row_max = h;
          row_j = k0 + c + 1;
        }
      }
      if (row_max > mine.s) mine = Best{row_max, i, row_j};

      if (!last) {  // the next stripe's boundary: H and the E carry at its left
        const int32_t h_end = __shfl_sync(FULL, H[COLS - 1], 31);
        const int32_t run_end = __shfl_sync(FULL, run, 31);
        if (lane == 0) edge[i - 1] = make_int2(h_end, run_end);
      }
      edge_h_prev = edge_h;
    }
    const Best stripe = warp_best(mine);
    if (better(stripe, best)) best = stripe;
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
              const void *m_len, const void *n_len, int ntasks, int reward, int penalty,
              int gap_open, int gap_extend, void *scratch, void *out, void *stream) {
  if (ntasks <= 0) return 0;
  const int blocks = (ntasks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  sw_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)q_all, (const uint8_t *)s_all, (const int64_t *)q_off,
      (const int64_t *)s_off, (const int32_t *)m_len, (const int32_t *)n_len, ntasks,
      reward, penalty, gap_open, gap_extend, (int2 *)scratch, (int32_t *)out);
  return (int)cudaGetLastError();
}

const char *sw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
