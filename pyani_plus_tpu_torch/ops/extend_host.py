"""Banded anchored alignment: gap filling and end extension for ANIm.

Replaces nucmer's postnuc stage (SURVEY.md section 2.2): clusters of
maximal matches become alignments by (a) aligning the regions between
consecutive anchors and (b) extending outward from the terminal anchors
to the best-scoring stop. Both run in a diagonal band around the
anchor-to-anchor diagonal with affine-gap (Gotoh) scoring: a gap run of
length L costs OPEN + EXTEND*(L-1), so OPEN == EXTEND recovers the
linear per-column model. Parameters are fitted empirically against the
reference .delta fixtures (nucmer's sw_align is not public in this
environment); parity is measured in tests.

The DP is anchored at the origin; for gap filling the end cell is also
anchored, for extension the end is free and the maximum-score cell
wins. Two error counters ride the optimal path as state payloads
rather than via traceback (plus the gap-column count):

- ``errors``   -- nucmer's *similarity errors* (delta header field 2):
  negative-scoring columns, i.e. every gap column plus every
  substitution that is not an exact A/C/G/T match (so N-vs-N counts);
  ANIm's identity uses this (ref methods/anim.py:100-127).
- ``nonid``    -- nucmer's *errors* (delta header field 1): character
  non-identities, i.e. gap columns plus substitutions whose characters
  differ (N-vs-N is the SAME character, so it does NOT count); this is
  what show-coords %idy -- and hence dnadiff AvgIdentity -- is built
  from, which is why the reference's 28-N self test expects dnadiff
  == 1.0 but ANIm == 0.9963 (ref tests/test_self_vs_self.py:83-86).

Each row is vectorised over the band (the
horizontal I state closes via a prefix cummax, since affine cost is
linear beyond the opening column), so cost is O(rows x band) numpy
work; the native C++ kernel (native/band.cpp) is bit-identical and is
the production path.
"""

from __future__ import annotations

import numpy as np

MATCH = 3
MISMATCH = -7
OPEN = -13  # first gap column
EXTEND = -7  # each further gap column

NEG = -(10**9)


def _band_dp(  # noqa: PLR0913, PLR0915
    a: np.ndarray,
    b: np.ndarray,
    band: int,
    *,
    free_end: bool,
    match: int = MATCH,
    mismatch: int = MISMATCH,
    gap_open: int = OPEN,
    gap_extend: int = EXTEND,
    stop_rows: int = 0,
    force_numpy: bool = False,
) -> tuple[int, int, int, int, int, int]:
    """Banded affine DP -> (best_i, best_j, best_score, errors, nonid,
    gapcols).

    Dispatches to the bit-identical native C++ kernel when available
    (parity-tested); force_numpy pins the numpy path.
    """
    m, n = int(a.size), int(b.size)
    if m == 0 and n == 0:
        return 0, 0, 0, 0, 0, 0
    if m == 0:
        return 0, n, gap_open + gap_extend * (n - 1), n, n, n
    if n == 0:
        return m, 0, gap_open + gap_extend * (m - 1), m, m, m
    if not force_numpy:
        from pyani_plus_tpu_torch.native import band_dp_native

        native = band_dp_native(
            a, b, band, free_end, match, mismatch, gap_open, gap_extend,
            stop_rows,
        )
        if native is not None:
            return native

    width = 2 * band + 1
    offs = np.arange(width)

    if free_end:
        # Extension follows the unit diagonal: both sequences advance at
        # the same rate (indels bounded by the band), regardless of how
        # long the remaining tails are.
        def center(i: int) -> int:
            return i

    else:

        def center(i: int) -> int:
            return (i * n) // m

    def pick(s1, e1, n1, g1, s2, e2, n2, g2):
        """Elementwise max of two states; first wins ties."""
        take2 = s2 > s1
        return (
            np.where(take2, s2, s1),
            np.where(take2, e2, e1),
            np.where(take2, n2, n1),
            np.where(take2, g2, g1),
        )

    c0 = center(0)
    js0 = offs + (c0 - band)
    zeros = np.zeros(width, dtype=np.int64)
    negs = np.full(width, NEG, dtype=np.int64)
    # State M holds the origin; I holds the row-0 horizontal runs.
    Ms = np.where(js0 == 0, 0, NEG).astype(np.int64)
    Me, Mn, Mg = zeros.copy(), zeros.copy(), zeros.copy()
    Ds, De, Dn, Dg = negs.copy(), zeros.copy(), zeros.copy(), zeros.copy()
    i_ok = (js0 >= 1) & (js0 <= n)
    Is_ = np.where(i_ok, gap_open + gap_extend * (js0 - 1), NEG).astype(np.int64)
    Ie = np.where(i_ok, js0, 0).astype(np.int64)
    In = Ie.copy()
    Ig = Ie.copy()

    best = (0, 0, 0, 0, 0, 0)
    if free_end:
        cs, ce, cn, cg = pick(
            *pick(Ms, Me, Mn, Mg, Ds, De, Dn, Dg), Is_, Ie, In, Ig
        )
        # Track best with the longer-extension tie rule over all k
        for k in range(width):
            sc = int(cs[k])
            if sc > best[2] or (sc == best[2] and 0 + int(js0[k]) > best[0] + best[1]):
                best = (0, int(js0[k]), sc, int(ce[k]), int(cn[k]), int(cg[k]))

    a16 = a.astype(np.int16)
    b16 = b.astype(np.int16)

    rows_since_improve = 0
    for i in range(1, m + 1):
        ci, cp = center(i), center(i - 1)
        shift = ci - cp
        js = offs + (ci - band)
        valid = (js >= 0) & (js <= n)

        def shifted(arr, offset, fill):
            idx = offs + shift - offset
            ok = (idx >= 0) & (idx < width)
            out = np.full(width, fill, dtype=arr.dtype)
            out[ok] = arr[idx[ok]]
            return out

        # M: from best3(prev) diagonally + substitution
        ps, pe, pn, pg = pick(
            *pick(Ms, Me, Mn, Mg, Ds, De, Dn, Dg), Is_, Ie, In, Ig
        )
        diag_s = shifted(ps, 1, NEG)
        diag_e = shifted(pe, 1, 0)
        diag_n = shifted(pn, 1, 0)
        diag_g = shifted(pg, 1, 0)
        in_b = valid & (js >= 1)
        bj = np.clip(js - 1, 0, n - 1)
        sub_ok = in_b & (b16[bj] == a16[i - 1]) & (a16[i - 1] < 4) & (b16[bj] < 4)
        sub_same = in_b & (b16[bj] == a16[i - 1])  # char identity (N==N)
        live = in_b & (diag_s > NEG // 2)
        nMs = np.where(live, diag_s + np.where(sub_ok, match, mismatch), NEG)
        nMe = np.where(live, diag_e + (~sub_ok), 0)
        nMn = np.where(live, diag_n + (~sub_same), 0)
        nMg = np.where(live, diag_g, 0)

        # D: vertical; open from max(M, I) (tie prefers M), continue from D.
        os_, oe, on, og = pick(Ms, Me, Mn, Mg, Is_, Ie, In, Ig)
        up_os = shifted(os_, 0, NEG)
        up_oe = shifted(oe, 0, 0)
        up_on = shifted(on, 0, 0)
        up_og = shifted(og, 0, 0)
        up_ds = shifted(Ds, 0, NEG)
        up_de = shifted(De, 0, 0)
        up_dn = shifted(Dn, 0, 0)
        up_dg = shifted(Dg, 0, 0)
        open_s = np.where(up_os > NEG // 2, up_os + gap_open, NEG)
        cont_s = np.where(up_ds > NEG // 2, up_ds + gap_extend, NEG)
        take_cont = cont_s >= open_s
        nDs = np.where(take_cont, cont_s, open_s)
        nDe = np.where(take_cont, up_de, up_oe) + 1
        nDn = np.where(take_cont, up_dn, up_on) + 1
        nDg = np.where(take_cont, up_dg, up_og) + 1
        dead_d = ~valid | (nDs <= NEG // 2)
        nDs = np.where(dead_d, NEG, nDs)
        nDe = np.where(dead_d, 0, nDe)
        nDn = np.where(dead_d, 0, nDn)
        nDg = np.where(dead_d, 0, nDg)
        nMs = np.where(valid, nMs, NEG)
        nMe = np.where(valid, nMe, 0)
        nMn = np.where(valid, nMn, 0)
        nMg = np.where(valid, nMg, 0)

        # I: horizontal runs within the row from base = max(M, D) (tie M):
        # I[k] = extend*k + max_{k'<k}(base[k'] + open - extend*(k'+1)),
        # latest k' achieving the running max as source.
        bs, be, bn, bg = pick(nMs, nMe, nMn, nMg, nDs, nDe, nDn, nDg)
        key = np.where(bs > NEG // 2, bs + gap_open - gap_extend * (offs + 1), NEG)
        run_max = np.maximum.accumulate(key)
        is_new = key >= run_max
        src = np.maximum.accumulate(np.where(is_new, offs, -1))
        left_max = np.concatenate(([NEG], run_max[:-1]))
        left_src = np.concatenate(([-1], src[:-1]))
        nIs = left_max + gap_extend * offs
        ok_i = valid & (js >= 1) & (left_src >= 0) & (left_max > NEG // 2)
        safe_src = np.clip(left_src, 0, width - 1)
        nIe = np.where(ok_i, be[safe_src] + (offs - safe_src), 0)
        nIn = np.where(ok_i, bn[safe_src] + (offs - safe_src), 0)
        nIg = np.where(ok_i, bg[safe_src] + (offs - safe_src), 0)
        nIs = np.where(ok_i, nIs, NEG)

        Ms, Me, Mn, Mg = nMs, nMe, nMn, nMg
        Ds, De, Dn, Dg = nDs, nDe, nDn, nDg
        Is_, Ie, In, Ig = nIs, nIe, nIn, nIg

        if free_end:
            cs, ce, cn, cg = pick(
                *pick(Ms, Me, Mn, Mg, Ds, De, Dn, Dg), Is_, Ie, In, Ig
            )
            k = int(np.argmax(cs))
            # scan ties for the largest i+j (mirror C++ per-k scan)
            tie = np.nonzero(cs == cs[k])[0]
            k = int(tie[np.argmax(js[tie])])
            sc = int(cs[k])
            if sc > best[2] or (sc == best[2] and i + int(js[k]) > best[0] + best[1]):
                best = (i, int(js[k]), sc, int(ce[k]), int(cn[k]), int(cg[k]))
                rows_since_improve = 0
            else:
                rows_since_improve += 1
                if stop_rows > 0 and rows_since_improve >= stop_rows:
                    break

    if free_end:
        return best
    cm = center(m)
    k = n - (cm - band)
    if 0 <= k < width:
        cs, ce, cn, cg = pick(
            *pick(Ms, Me, Mn, Mg, Ds, De, Dn, Dg), Is_, Ie, In, Ig
        )
        if cs[k] > NEG // 2:
            return m, n, int(cs[k]), int(ce[k]), int(cn[k]), int(cg[k])
    return (  # pragma: no cover - band missed corner
        m, n, NEG, max(m, n), max(m, n), abs(m - n)
    )


def gap_errors(
    a: np.ndarray, b: np.ndarray, band: int | None = None
) -> tuple[int, int, int]:
    """(sim error columns, non-identity columns, gap columns) of the
    end-anchored alignment of two gap segments."""
    if a.size == 0:
        return int(b.size), int(b.size), int(b.size)
    if b.size == 0:
        return int(a.size), int(a.size), int(a.size)
    if band is None:
        band = max(20, abs(int(a.size) - int(b.size)) + 20)
    band = int(min(band, max(a.size, b.size)))
    _, _, _, errors, nonid, gapcols = _band_dp(a, b, band, free_end=False)
    return int(errors), int(nonid), int(gapcols)


def extend_errors(
    a: np.ndarray, b: np.ndarray, band: int = 60, breaklen: int = 200
) -> tuple[int, int, int, int, int]:
    """Extend from the origin into a and b; return (a_len, b_len, errors,
    nonid, gap_columns) of the best-scoring extension (may be all zero).

    The useful search region is bounded by the shorter tail plus the
    breaklen slack (an extension cannot usefully outrun the nearer
    sequence end by more than the give-up distance), and the DP gives
    up after 3*breaklen rows without improving the best score --
    nucmer's Extend_Alignment abandons after ~breaklen columns, so the
    generous 3x cutoff preserves its observable results (fixture
    parity unchanged) while collapsing dead extensions.
    """
    if a.size == 0 or b.size == 0:
        return 0, 0, 0, 0, 0
    limit = min(a.size, b.size) + breaklen
    a = a[:limit]
    b = b[:limit]
    band = int(min(band, max(a.size, b.size)))
    i, j, _score, errors, nonid, gapcols = _band_dp(
        a, b, band, free_end=True, stop_rows=3 * breaklen
    )
    return int(i), int(j), int(errors), int(nonid), int(gapcols)
