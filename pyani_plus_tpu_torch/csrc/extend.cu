// Batched free-end banded Gotoh extensions for ANIm, one warp per task.
//
// Replaces the Pallas TPU kernel pyani_plus_tpu/ops/extend_pallas.py
// (_make_kernel) and computes exactly what the host oracle computes
// (pyani_plus_tpu/native/band.cpp, band_affine with free_end = 1):
// band +-60 around the unit diagonal (121 live columns), three states
// M/D/I each carrying (score, errors, nonid, gap columns), best cell
// with the longer-extension tie rule, and the give-up rule after
// stop_rows rows without improvement.
//
// Layout: lane L of a warp owns band columns 4L .. 4L+3 (columns >= 121
// are permanently dead), so the whole band state of a task lives in
// registers: 4 columns x 12 ints. Warps are independent (no shared
// memory, no __syncthreads); a block holds 4 of them.
//
// Per row i (j = k + i - 60 for column k):
//   - M at column k takes its predecessor from the same column of the
//     previous row (best3 with tie preference M >= D >= I);
//   - D at column k takes column k+1 of the previous row: the next
//     register within a lane, __shfl_down_sync across lanes;
//   - I is an exclusive prefix "max, keep the right operand on ties"
//     over (key, e - k, n - e, g - e): serial over the lane's 4 columns,
//     then a 5-step __shfl_up_sync scan across the warp;
//   - the best cell follows the host's per-row rule: the row's maximum
//     score (__reduce_max_sync), the largest column that holds it, and
//     an update on a greater score or an equal score with larger i + j.
//     No packed score/position key is used, so no row count overflows.
//
// What bounds it on an H100: each task is a serial chain of up to ~10^4
// dependent rows, each a few hundred instructions with ~40 warp
// shuffles, so a task's time is latency, not bytes or FLOPs. A batch of
// 64-1000 tasks fills only part of the 132 SMs (4 warps per block).
// wgmma and TMA do not apply (integer max-plus, no matrix product, a few
// bytes read per row); packing more pairs into one launch is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libextend.so extend.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 60;
constexpr int WIDTH = 2 * BAND + 1;  // 121 live band columns
constexpr int COLS = 4;              // band columns per lane
constexpr int WARPS_PER_BLOCK = 4;
constexpr int32_t NEG = -1000000000;
constexpr int32_t NEG_HALF = NEG / 2;
constexpr unsigned FULL = 0xffffffffu;

struct Cell {
  int32_t s, e, n, g;
};

// Scan element of the I state: key plus payloads stored relative to the
// source column, so that any later column can rebuild them.
struct Run {
  int32_t key, ea, dn, dg;
};

__device__ __forceinline__ Cell dead() { return Cell{NEG, 0, 0, 0}; }

// Max of two states; the first wins ties.
__device__ __forceinline__ Cell pick(const Cell &x, const Cell &y) {
  return y.s > x.s ? y : x;
}

// Prefix combine: left wins only when strictly greater (latest source on
// ties, the host's `key >= run_max`).
__device__ __forceinline__ Run combine(const Run &left, const Run &right) {
  return left.key > right.key ? left : right;
}

__device__ __forceinline__ Run shfl_up(const Run &r, int delta) {
  return Run{__shfl_up_sync(FULL, r.key, delta), __shfl_up_sync(FULL, r.ea, delta),
             __shfl_up_sync(FULL, r.dn, delta), __shfl_up_sync(FULL, r.dg, delta)};
}

__device__ __forceinline__ Cell shfl_down(const Cell &c) {
  return Cell{__shfl_down_sync(FULL, c.s, 1), __shfl_down_sync(FULL, c.e, 1),
              __shfl_down_sync(FULL, c.n, 1), __shfl_down_sync(FULL, c.g, 1)};
}

struct Best {
  int32_t i, j, s, e, n, g;
};

// The host's per-row best-cell rule. cs/ce/cn/cg are this lane's cells
// of row i; returns true (warp-uniform) when the best improved.
__device__ __forceinline__ bool update_best(Best &best, const Cell (&cell)[COLS],
                                            int i, int k0) {
  int32_t rmax = cell[0].s;
#pragma unroll
  for (int c = 1; c < COLS; c++) rmax = max(rmax, cell[c].s);
  rmax = __reduce_max_sync(FULL, rmax);
  int kc = -1;
  Cell sel = dead();
#pragma unroll
  for (int c = 0; c < COLS; c++) {
    if (cell[c].s == rmax) {
      kc = k0 + c;
      sel = cell[c];
    }
  }
  const int kmax = __reduce_max_sync(FULL, kc);
  const int32_t jbest = kmax + i - BAND;
  const bool upd = rmax > best.s || (rmax == best.s && i + jbest > best.i + best.j);
  if (upd) {
    const int src = kmax / COLS;
    best.i = i;
    best.j = jbest;
    best.s = rmax;
    best.e = __shfl_sync(FULL, sel.e, src);
    best.n = __shfl_sync(FULL, sel.n, src);
    best.g = __shfl_sync(FULL, sel.g, src);
  }
  return upd;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    extend_kernel(const uint8_t *__restrict__ a_all, const uint8_t *__restrict__ b_all,
                  const int64_t *__restrict__ a_off, const int64_t *__restrict__ b_off,
                  const int32_t *__restrict__ m_len, const int32_t *__restrict__ n_len,
                  int ntasks, int stop_rows, int match, int mismatch, int gap_open,
                  int gap_extend, int32_t *__restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (task >= ntasks) return;  // the whole warp leaves together
  const uint8_t *a = a_all + a_off[task];
  const uint8_t *b = b_all + b_off[task];
  const int m = m_len[task];
  const int n = n_len[task];
  const int k0 = lane * COLS;

  Cell M[COLS], D[COLS], I[COLS];
  // Row 0: the origin lives in M at j == 0; I holds the horizontal runs.
#pragma unroll
  for (int c = 0; c < COLS; c++) {
    const int k = k0 + c;
    const int j = k - BAND;
    M[c] = (k < WIDTH && j == 0) ? Cell{0, 0, 0, 0} : dead();
    D[c] = dead();
    I[c] = (k < WIDTH && j >= 1 && j <= n)
               ? Cell{gap_open + gap_extend * (j - 1), j, j, j}
               : dead();
  }
  Best best{0, 0, 0, 0, 0, 0};
  {
    Cell cell[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) cell[c] = pick(pick(M[c], D[c]), I[c]);
    update_best(best, cell, 0, k0);
  }

  int rows_since = 0;
  for (int i = 1; i <= m; i++) {
    const int ac = a[i - 1];
    const int jbase = i - BAND;

    // Column k+1 of the previous row, for D at the lane's last column.
    Cell om[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) om[c] = pick(M[c], I[c]);
    Cell om_next = shfl_down(om[0]);
    Cell d_next = shfl_down(D[0]);
    if (lane == 31) om_next = d_next = dead();

    Cell nM[COLS], nD[COLS];
    bool valid[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      const int k = k0 + c;
      const int j = k + jbase;
      valid[c] = k < WIDTH && j >= 0 && j <= n;
      // --- M: diagonal predecessor (same column), best3 M >= D >= I
      const Cell p = pick(pick(M[c], D[c]), I[c]);
      if (valid[c] && j >= 1 && p.s > NEG_HALF) {
        const int bc = b[j - 1];
        const bool sub_ok = bc == ac && ac < 4 && bc < 4;
        nM[c] = Cell{p.s + (sub_ok ? match : mismatch), p.e + (sub_ok ? 0 : 1),
                     p.n + (bc == ac ? 0 : 1), p.g};
      } else {
        nM[c] = dead();
      }
      // --- D: vertical predecessor is column k+1 of the previous row
      const Cell uo = c + 1 < COLS ? om[c + 1] : om_next;
      const Cell ud = c + 1 < COLS ? D[c + 1] : d_next;
      const int32_t open_s = uo.s > NEG_HALF ? uo.s + gap_open : NEG;
      const int32_t cont_s = ud.s > NEG_HALF ? ud.s + gap_extend : NEG;
      Cell d = cont_s >= open_s ? Cell{cont_s, ud.e + 1, ud.n + 1, ud.g + 1}
                                : Cell{open_s, uo.e + 1, uo.n + 1, uo.g + 1};
      nD[c] = (!valid[c] || d.s <= NEG_HALF) ? dead() : d;
    }

    // --- I: exclusive prefix of the row's open keys, latest source on ties
    Run v[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      const int k = k0 + c;
      const Cell base = nM[c].s >= nD[c].s ? nM[c] : nD[c];
      const int32_t key =
          base.s > NEG_HALF ? base.s + gap_open - gap_extend * (k + 1) : NEG;
      v[c] = Run{key, base.e - k, base.n - base.e, base.g - base.e};
    }
    Run agg = v[0];
#pragma unroll
    for (int c = 1; c < COLS; c++) agg = combine(agg, v[c]);
#pragma unroll
    for (int delta = 1; delta < 32; delta *= 2) {
      const Run left = shfl_up(agg, delta);
      if (lane >= delta) agg = combine(left, agg);
    }
    Run run = shfl_up(agg, 1);
    if (lane == 0) run = Run{NEG, 0, 0, 0};

    Cell cell[COLS];
#pragma unroll
    for (int c = 0; c < COLS; c++) {
      const int k = k0 + c;
      const int j = k + jbase;
      const Run left = run;
      run = combine(run, v[c]);
      Cell nI = dead();
      if (valid[c] && j >= 1 && left.key > NEG_HALF) {
        const int32_t e = left.ea + k;
        nI = Cell{left.key + gap_extend * k, e, e + left.dn, e + left.dg};
      }
      M[c] = nM[c];
      D[c] = nD[c];
      I[c] = nI;
      cell[c] = pick(pick(nM[c], nD[c]), nI);
    }

    if (update_best(best, cell, i, k0)) {
      rows_since = 0;
    } else if (stop_rows > 0 && ++rows_since >= stop_rows) {
      break;
    }
  }

  if (lane == 0) {
    int32_t *o = out + (int64_t)task * 5;
    o[0] = best.i;
    o[1] = best.j;
    o[2] = best.e;
    o[3] = best.n;
    o[4] = best.g;
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
