// Native banded anchored DP (gap fill + free-end extension for ANIm).
//
// Affine-gap (Gotoh) generalisation of the linear model: a gap run of
// length L costs open + extend*(L-1), so open == extend reduces to the
// linear per-column model. Three states per cell (M = substitution,
// D = gap in b / vertical, I = gap in a / horizontal) each carry
// (score, errors, nonid, gap_columns) payloads -- errors counts
// negative-scoring columns (nucmer sim_errors: N-vs-N included),
// nonid counts character non-identities (nucmer errors: N-vs-N is the
// same character so excluded); gaps increment both. Mirrors
// pyani_plus_tpu/ops/extend.py::_band_dp bit-for-bit (parity-tested):
//   - M predecessor = max(M, D, I) with tie preference M >= D >= I;
//   - D = max(max(M, I)_up + open, D_up + extend), tie prefers the
//     continuation (extend);
//   - I within a row via running max of base = max(M, D) with the
//     *latest* index achieving the running key max as source;
//   - cell best = max(M, D, I), tie preference M >= D >= I;
//   - free-end best updates on strictly-greater score, or equal score
//     with larger i+j (prefer longer extensions).
//
// Layout: struct-of-arrays int32 state (scores bounded by 3*|seq| <<
// 2^31), two row buffers swapped per row, and ONE fused pass per row:
// nM/nD at k need only the previous row, nI at k needs only nM/nD at
// k' < k (running prefix max), and the free-end best scan folds into
// the same loop. Out-of-band cells are killed explicitly so stale
// buffer contents never leak into the next row's reads.
//
// Build: g++ -O3 -shared -fPIC band.cpp -o libband.so

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {
constexpr int32_t NEG = -1000000000;
constexpr int32_t NEG_HALF = NEG / 2;
}  // namespace

extern "C" {

// out[6] = {best_i, best_j, best_score, errors, nonid, gapcols}
// stop_rows: free-end early termination -- give up after this many rows
// without a best-score improvement (0 = never). nucmer's Extend_Alignment
// abandons an extension after breaklen columns without improvement, so a
// generous multiple of breaklen preserves its observable results while
// collapsing dead extensions in divergent regions.
void band_affine(const uint8_t *a, int64_t m, const uint8_t *b, int64_t n,
                 int64_t band, int free_end, int match, int mismatch,
                 int open_, int extend, int64_t stop_rows, int64_t *out) {
  const int64_t width = 2 * band + 1;
  // 12 state arrays x 2 row buffers, one allocation.
  std::vector<int32_t> buf((size_t)(24 * width), 0);
  int32_t *Ms = buf.data(), *Me = Ms + width, *Mn = Me + width, *Mg = Mn + width;
  int32_t *Ds = Mg + width, *De = Ds + width, *Dn = De + width, *Dg = Dn + width;
  int32_t *Is = Dg + width, *Ie = Is + width, *In = Ie + width, *Ig = In + width;
  int32_t *nMs = Ig + width, *nMe = nMs + width, *nMn = nMe + width, *nMg = nMn + width;
  int32_t *nDs = nMg + width, *nDe = nDs + width, *nDn = nDe + width, *nDg = nDn + width;
  int32_t *nIs = nDg + width, *nIe = nIs + width, *nIn = nIe + width, *nIg = nIn + width;

  auto center = [&](int64_t i) -> int64_t {
    return free_end ? i : (i * n) / m;
  };

  const int64_t c0 = center(0);
  for (int64_t k = 0; k < width; k++) {
    const int64_t j = k + (c0 - band);
    Ms[k] = Ds[k] = Is[k] = NEG;
    Me[k] = Mn[k] = Mg[k] = De[k] = Dn[k] = Dg[k] = Ie[k] = In[k] = Ig[k] = 0;
    if (j == 0) {
      Ms[k] = 0;  // origin lives in M by convention
    } else if (j > 0 && j <= n) {
      Is[k] = open_ + extend * (int32_t)(j - 1);
      Ie[k] = In[k] = Ig[k] = (int32_t)j;
    }
  }
  int64_t best_i = 0, best_j = 0;
  int32_t best_s = 0, best_e = 0, best_n = 0, best_g = 0;
  int64_t rows_since_improve = 0;
  if (free_end) {
    for (int64_t k = 0; k < width; k++) {
      int32_t cs = Ms[k], ce = Me[k], cn = Mn[k], cg = Mg[k];
      if (Ds[k] > cs) { cs = Ds[k]; ce = De[k]; cn = Dn[k]; cg = Dg[k]; }
      if (Is[k] > cs) { cs = Is[k]; ce = Ie[k]; cn = In[k]; cg = Ig[k]; }
      const int64_t j = k + (c0 - band);
      if (cs > best_s || (cs == best_s && j > best_i + best_j)) {
        best_i = 0;
        best_j = j;
        best_s = cs;
        best_e = ce;
        best_n = cn;
        best_g = cg;
      }
    }
  }

  for (int64_t i = 1; i <= m; i++) {
    const int64_t ci = center(i), cp = center(i - 1);
    const int64_t shift = ci - cp;
    const uint8_t ac = a[i - 1];
    const int64_t base_j = ci - band;
    int64_t k_lo = base_j < 0 ? -base_j : 0;
    int64_t k_hi = n - base_j;
    if (k_hi > width - 1) k_hi = width - 1;

    // Kill out-of-band cells so the next row never reads stale state.
    for (int64_t k = 0; k < k_lo && k < width; k++)
      nMs[k] = nDs[k] = nIs[k] = NEG, nMe[k] = nMn[k] = nMg[k] = nDe[k] =
          nDn[k] = nDg[k] = nIe[k] = nIn[k] = nIg[k] = 0;
    for (int64_t k = (k_hi < -1 ? 0 : k_hi + 1); k < width; k++)
      nMs[k] = nDs[k] = nIs[k] = NEG, nMe[k] = nMn[k] = nMg[k] = nDe[k] =
          nDn[k] = nDg[k] = nIe[k] = nIn[k] = nIg[k] = 0;

    int64_t run_max = (int64_t)NEG, run_src = -1;
    bool improved = false;
    for (int64_t k = k_lo; k <= k_hi; k++) {
      const int64_t j = k + base_j;
      // --- M: diagonal predecessor best3 + substitution
      int32_t m_s = NEG, m_e = 0, m_n = 0, m_g = 0;
      const int64_t di = k + shift - 1;
      if (j >= 1 && di >= 0 && di < width) {
        int32_t ps = Ms[di], pe = Me[di], pn = Mn[di], pg = Mg[di];
        if (Ds[di] > ps) { ps = Ds[di]; pe = De[di]; pn = Dn[di]; pg = Dg[di]; }
        if (Is[di] > ps) { ps = Is[di]; pe = Ie[di]; pn = In[di]; pg = Ig[di]; }
        if (ps > NEG_HALF) {
          const uint8_t bc = b[j - 1];
          const bool sub_ok = (bc == ac) && ac < 4 && bc < 4;
          m_s = ps + (sub_ok ? match : mismatch);
          m_e = pe + (sub_ok ? 0 : 1);
          m_n = pn + (bc == ac ? 0 : 1);  // char identity: N==N not an error
          m_g = pg;
        }
      }
      nMs[k] = m_s; nMe[k] = m_e; nMn[k] = m_n; nMg[k] = m_g;
      // --- D: vertical; open from max(M, I), continue from D
      int32_t d_s = NEG, d_e = 0, d_n = 0, d_g = 0;
      const int64_t ui = k + shift;
      if (ui >= 0 && ui < width) {
        int32_t om_s = Ms[ui], om_e = Me[ui], om_n = Mn[ui], om_g = Mg[ui];
        if (Is[ui] > om_s) {
          om_s = Is[ui]; om_e = Ie[ui]; om_n = In[ui]; om_g = Ig[ui];
        }
        const int32_t open_s = om_s > NEG_HALF ? om_s + open_ : NEG;
        const int32_t cont_s = Ds[ui] > NEG_HALF ? Ds[ui] + extend : NEG;
        if (cont_s >= open_s) {
          if (cont_s > NEG_HALF) {
            d_s = cont_s; d_e = De[ui] + 1; d_n = Dn[ui] + 1; d_g = Dg[ui] + 1;
          }
        } else {
          d_s = open_s; d_e = om_e + 1; d_n = om_n + 1; d_g = om_g + 1;
        }
      }
      nDs[k] = d_s; nDe[k] = d_e; nDn[k] = d_n; nDg[k] = d_g;
      // --- I: horizontal run from base = max(M, D) at k' < k
      // I[k] = extend*k + max_{k'<k} (base[k'] + open - extend*(k'+1)),
      // latest k' achieving the running max as source.
      int32_t i_s = NEG, i_e = 0, i_n = 0, i_g = 0;
      if (j >= 1 && run_src >= 0) {
        const int64_t s = run_max + (int64_t)extend * k;
        if (s > NEG_HALF) {
          i_s = (int32_t)s;
          const int32_t run = (int32_t)(k - run_src);
          if (nMs[run_src] >= nDs[run_src]) {
            i_e = nMe[run_src] + run;
            i_n = nMn[run_src] + run;
            i_g = nMg[run_src] + run;
          } else {
            i_e = nDe[run_src] + run;
            i_n = nDn[run_src] + run;
            i_g = nDg[run_src] + run;
          }
        }
      }
      nIs[k] = i_s; nIe[k] = i_e; nIn[k] = i_n; nIg[k] = i_g;
      // update the running key max with this cell's base
      const int32_t bse_s = m_s >= d_s ? m_s : d_s;
      if (bse_s > NEG_HALF) {
        const int64_t key = (int64_t)bse_s + open_ - (int64_t)extend * (k + 1);
        if (key >= run_max) {
          run_max = key;
          run_src = k;
        }
      }
      // --- free-end best scan, fused
      if (free_end) {
        int32_t cs = m_s, ce = m_e, cn = m_n, cg = m_g;
        if (d_s > cs) { cs = d_s; ce = d_e; cn = d_n; cg = d_g; }
        if (i_s > cs) { cs = i_s; ce = i_e; cn = i_n; cg = i_g; }
        if (cs > best_s || (cs == best_s && i + j > best_i + best_j)) {
          best_i = i;
          best_j = j;
          best_s = cs;
          best_e = ce;
          best_n = cn;
          best_g = cg;
          improved = true;
        }
      }
    }
    std::swap(Ms, nMs); std::swap(Me, nMe); std::swap(Mn, nMn);
    std::swap(Mg, nMg);
    std::swap(Ds, nDs); std::swap(De, nDe); std::swap(Dn, nDn);
    std::swap(Dg, nDg);
    std::swap(Is, nIs); std::swap(Ie, nIe); std::swap(In, nIn);
    std::swap(Ig, nIg);

    if (free_end) {
      if (improved) rows_since_improve = 0;
      else if (stop_rows > 0 && ++rows_since_improve >= stop_rows) break;
    }
  }

  if (free_end) {
    out[0] = best_i;
    out[1] = best_j;
    out[2] = best_s;
    out[3] = best_e;
    out[4] = best_n;
    out[5] = best_g;
    return;
  }
  const int64_t cm = center(m);
  const int64_t k = n - (cm - band);
  int32_t fs = NEG, fe = 0, fn = 0, fg = 0;
  if (k >= 0 && k < width) {
    fs = Ms[k]; fe = Me[k]; fn = Mn[k]; fg = Mg[k];
    if (Ds[k] > fs) { fs = Ds[k]; fe = De[k]; fn = Dn[k]; fg = Dg[k]; }
    if (Is[k] > fs) { fs = Is[k]; fe = Ie[k]; fn = In[k]; fg = Ig[k]; }
  }
  if (fs > NEG_HALF) {
    out[0] = m;
    out[1] = n;
    out[2] = fs;
    out[3] = fe;
    out[4] = fn;
    out[5] = fg;
  } else {
    out[0] = m;
    out[1] = n;
    out[2] = NEG;
    out[3] = (m > n ? m : n);
    out[4] = (m > n ? m : n);
    out[5] = (m > n ? m - n : n - m);
  }
}

}  // extern "C"
