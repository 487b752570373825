"""minimap2-semantics mapping: sketch, anchors, chaining, PAF records.

Replaces the minimap2 binary for the ANIminimap2 method. The reference
runs minimap2 WITHOUT -c (private_cli.py:1499-1549), so PAF columns 10
and 11 (nmatch, block length) are the chain's anchor accounting (mlen /
blen), not a base-level alignment -- reproducing the tool therefore
means reproducing its seeding and chaining exactly:

- mm_sketch semantics (native/mm2.cpp): invertible Wang hash64 over
  2-bit packed canonical k-mers, window minima with minimap2's tie
  handling, k-mer END positions;
- occurrence filter: seeds with reference-index occurrence above
  mid_occ are skipped, mid_occ = max(50, occurrence at the (1 - 2e-4)
  quantile of the distinct-minimizer occurrence distribution + 1)
  (mm_idx_cal_max_occ; the asm presets floor min_mid_occ at 50 --
  empirically REQUIRED: all four bacterial fixture self pairs only
  become bit-exact when repeat seeds up to occurrence 43 survive);
- seed rescue (select_seeds = mm_seed_select): filtered high-occurrence
  seeds are re-admitted, lowest occurrence first, with a per-gap quota
  of int(gap/500 + .499);
- anchors: (target_end, query_end) per relative strand, reverse-strand
  query coordinates flipped into the reverse-complement frame;
- chaining (native/mm2.cpp mm2_chain_rmq2 = mg_chain_rmq, lchain.c
  >= 2.24): candidates are the single range-max anchor of a surrogate
  priority f[j] + .5*chn_pen_gap*(x_j+y_j) over the (x, y) windows,
  plus a serial inner scan (rmq_inner_dist) by descending y with the
  DP skip heuristic, run when the RMQ candidate is not exact; true
  score f[j] + min(dq, dr, span) - (int)(chn_pen_gap*dd +
  0.5*mg_log2(dd+1)) gated on width dd <= bw, chn_pen_gap =
  chain_gap_scale(0.8)*0.01*k, fast bit-trick log2;
- TWO passes (map.c): pass 1 with (max_gap, bw); if the best chain
  leaves > rmq_rescue_size bp of the query bare or spans >
  rmq_rescue_ratio of it, the anchors surviving pass-1 chains re-chain
  with bw_long as window and width -- the long-join rescue that fuses
  flanks across multi-kb structural insertions (this is what makes the
  96.6%-ANI bacterial fixture pair bit-exact: a 26 kb strain-specific
  insertion is spanned in-chain, adding its gap columns to blen);
- backtrack (mg_chain_backtrack): peaks by descending score, walks
  truncated where the cumulative score drops > max_drop (= bw) below
  its running max, burned anchors past the cut;
- chains kept when score >= 40 (-m) and anchors >= 3 (-n);
- primary selection by query-extent overlap (mask_level 0.5);
- mlen += min(dq, dr, span), blen += max(dq, dr) per adjacent anchor
  pair (+span for the first anchor) -- the PAF nmatch/blocklen pair.

mapq: the reference parser only drops rows with mapq == 0
(animinimap2.py:99-101); the formula in _mapq reproduces both viral
fixture datapoints exactly.

Parity status: exact (homologous), bounded (null). All 9 viral PAFs
bit-identical; bacterial self pairs and the two 99.66% cross pairs
bit-exact (identity to 1 ulp, aln integer-exact). The ~11-15%-identity
NO-HOMOLOGY bacterial pairs (spurious asm20 chains over unrelated
genomes) carry a measured residual cap of 6.6e-4 identity / 0.78% aln
(worst pair NC_014100 vs NC_002696; full table in the round-4 sweep,
tests/test_animinimap2.py gates at 7e-4/0.9%). The deviation survives
every kernel-semantic hypothesis the matrix-only oracle can test:
pri_mode variants, inner-scan distance, max_gap/min_sc/size_cap sweeps,
and the RMQ_FLAGS micro-semantics (dq<=0 rejection, always-inner-scan,
open window bound) are all no-ops or worse on every fixture pair.
ROUND-5 measurements (tools/mm2_junk_residue_experiment.py) refuted the
remaining named suspects directly: the inner-scan SKIP ORDER
(descending-y vs mg_chain_dp's descending-index, RMQ flag bit 8) is a
bit-exact no-op on all four junk pairs; the size-cap EVICTION schedule
never triggers (max 43k anchors per chain call vs the 100k cap); and
mapq-0 gating accounts for < 2.2 kb of the ~13.1 kb deficit. What IS
measured: the deficit is query-side and subject-independent (identical
-13123 query-union shortfall vs two different subjects, with identical
uncovered-interval maps), i.e. minimap2 additionally covers ~13 kb of
conserved islands (rRNA-operon scale) inside the ~1 Mb of no-homology
deserts where this pipeline emits no chain -- a chain-formation/
threshold boundary effect on genuinely-homologous micro-islands that a
matrix-only oracle cannot localise further. Numerically irrelevant
downstream (the pairs are reported as no-homology either way).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PRESET_PARAMS = {  # minimap2 asm presets (options.c): (k, w)
    "asm5": (19, 19),
    "asm10": (19, 19),
    "asm20": (19, 10),
}
# Chain limits: the asm presets' man-page line is
# "-k19 -w10/-w19 -U50,500 --rmq -r1k,100k -g10k" -- see the module
# docstring for how each lands in the two-pass mg_chain_rmq below.
MAX_GAP = 10000
BW = 1000
BW_LONG = 100000
CHAIN_GAP_SCALE = 0.8
MAX_SKIP = 25
MIN_CHAIN_SCORE = 40  # -m
MIN_CNT = 3  # -n
MASK_LEVEL = 0.5
MID_OCC_FRAC = 2e-4
# asm presets pin -U50,500 (man page): mid_occ floored at 50 (repeat
# seeds up to occurrence 50 always survive -- required for bacterial
# self-pair exactness) and capped at 500
MIN_MID_OCC = 50
MAX_MID_OCC = 500
# seed rescue (mm_seed_select, seed.c): in query gaps left by the
# occurrence filter, re-admit the least-occurring high-occurrence seeds
# -- quota int(gap/OCC_DIST + .499) per gap, occurrence <= MAX_MAX_OCC,
# at most MAX_HIGH_OCC candidates considered per gap
MAX_MAX_OCC = 4095
OCC_DIST = 500
MAX_HIGH_OCC = 128
# mg_chain_rmq (two-pass) parameters; pass 1 chains with (max_gap, bw),
# then if the top chain leaves > rmq_rescue_size bp of the query bare or
# spans > rmq_rescue_ratio of it, the surviving chain anchors re-chain
# with bw_long as both window and width (the long-join rescue)
RMQ_INNER_DIST = 1000
RMQ_SIZE_CAP = 100000
RMQ_RESCUE_SIZE = 1000
RMQ_RESCUE_RATIO = 0.1
RMQ_PRI_MODE = 0
# Semantic micro-variants of the kernel (native mm2.cpp). Bit 1 rejects
# dq <= 0 predecessor joins the way minimap2's comput_sc does (INT32_MIN
# for zero query advance); measured as a no-op on every fixture pair, so
# the faithful semantics are kept on by default.
RMQ_FLAGS = 1
PASS1_MIN_SC = MIN_CHAIN_SCORE
PASS1_MIN_CNT = MIN_CNT


@dataclass
class PafRecord:
    """One PAF row (coordinates 0-based half-open, original strands)."""

    qstart: int
    qend: int
    strand: str  # "+" / "-"
    tstart: int
    tend: int
    mlen: int  # col 10: number of matching bases (anchor accounting)
    blen: int  # col 11: alignment block length
    mapq: int
    cnt: int  # cm:i anchor count
    score: int  # s1:i chain score
    subsc: int  # s2:i best secondary score
    qseq_id: int = 0
    tseq_id: int = 0


def sketch(codes: np.ndarray, k: int, w: int):
    """(hashes, end_positions, strand01) via the native mm_sketch."""
    from pyani_plus_tpu_torch.native import mm2_sketch_native

    result = mm2_sketch_native(codes, k, w)
    if result is None:  # pragma: no cover - no compiler
        raise RuntimeError("mm2 native kernel unavailable")
    return result


def mid_occ_threshold(ref_hashes: np.ndarray) -> int:
    """minimap2 mid_occ: occurrence cap for seeding.

    >>> import numpy as np
    >>> mid_occ_threshold(np.arange(100, dtype=np.uint64))  # all unique
    50
    >>> mid_occ_threshold(np.zeros(1000, dtype=np.uint64))  # one hash
    500
    """
    if ref_hashes.size == 0:
        return MIN_MID_OCC
    _, counts = np.unique(ref_hashes, return_counts=True)
    counts.sort()
    idx = int((1.0 - MID_OCC_FRAC) * counts.size)
    idx = min(idx, counts.size - 1)
    return min(MAX_MID_OCC, max(MIN_MID_OCC, int(counts[idx]) + 1))


def select_seeds(
    counts: np.ndarray, qend: np.ndarray, qlen: int, mid_occ: int
) -> np.ndarray:
    """mm_seed_select (seed.c): keep mask over seeds in emission order.

    Seeds with index occurrence <= mid_occ are kept outright. Each query
    gap between consecutive kept seeds (and the sequence ends) re-admits
    up to ``int(gap_span/OCC_DIST + .499)`` of its least-occurring
    filtered seeds (occurrence ties broken by seed order), considering
    only seeds with occurrence <= MAX_MAX_OCC and at most MAX_HIGH_OCC
    eligible candidates per gap, scanned in position order.

    >>> import numpy as np
    >>> counts = np.array([1, 90, 80, 90, 1])   # three filtered seeds
    >>> qend = np.array([10, 300, 600, 900, 1200])
    >>> select_seeds(counts, qend, 1300, 50).tolist()  # gap quota = 2
    [True, True, True, False, True]
    >>> select_seeds(np.array([1, 90, 1]), np.array([10, 60, 110]),
    ...              200, 50).tolist()  # 99 bp gap: quota 0
    [True, False, True]
    """
    keep = counts <= mid_occ
    if keep.all():
        return keep
    n = counts.size
    bounds = [-1, *np.nonzero(keep)[0].tolist(), n]
    for gi in range(len(bounds) - 1):
        last0, nxt = bounds[gi], bounds[gi + 1]
        if nxt - last0 <= 1:
            continue
        ps = 0 if last0 < 0 else int(qend[last0]) + 1
        pe = qlen if nxt == n else int(qend[nxt])
        quota = int((pe - ps) / OCC_DIST + 0.499)
        if quota <= 0:
            continue
        cand = [j for j in range(last0 + 1, nxt) if counts[j] <= MAX_MAX_OCC]
        cand = cand[:MAX_HIGH_OCC]
        cand.sort(key=lambda j: (counts[j], j))
        for j in cand[:quota]:
            keep[j] = True
    return keep


def collect_anchors(  # noqa: PLR0913
    index: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    qry_hashes: np.ndarray,
    qry_pos: np.ndarray,
    qry_strand: np.ndarray,
    qlen: int,
    k: int,
    mid_occ: int,
) -> dict[tuple[int, int], tuple[np.ndarray, np.ndarray]]:
    """{(tid, relative_strand): (x, y)} anchors sorted by (x, y).

    ``index`` is the combined hash-sorted target index (hashes, pos,
    strand, tid) over every target record, as a single .mmi would hold;
    occurrence counts -- both for the mid_occ filter and the
    mm_seed_select rescue -- are totals across the whole index.
    """
    rh, rp, rs, rt = index
    lo = np.searchsorted(rh, qry_hashes, side="left")
    hi = np.searchsorted(rh, qry_hashes, side="right")
    counts = hi - lo
    has = counts > 0
    if not has.any():
        return {}
    seed_idx = np.nonzero(has)[0]
    keep_seeds = select_seeds(counts[seed_idx], qry_pos[seed_idx], qlen, mid_occ)
    kept = seed_idx[keep_seeds]
    if kept.size == 0:
        return {}
    q_idx = np.repeat(kept, counts[kept])
    offsets = np.concatenate(
        [np.arange(c) + start for c, start in zip(counts[kept], lo[kept])]
    )
    x = rp[offsets].astype(np.int64)
    tid = rt[offsets]
    rel = (qry_strand[q_idx] != rs[offsets]).astype(np.int8)  # 1 = reverse
    qpos = qry_pos[q_idx].astype(np.int64)
    out: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    for t in np.unique(tid):
        for strand_rel in (0, 1):
            sel = (tid == t) & (rel == strand_rel)
            if not sel.any():
                continue
            xs = x[sel]
            if strand_rel == 0:
                ys = qpos[sel]
            else:
                # END position of the k-mer in the reverse-complement frame
                ys = qlen - qpos[sel] + k - 2
            o = np.lexsort((ys, xs))
            out[int(t), strand_rel] = (xs[o], ys[o].astype(np.int32))
    return out


def build_index(
    ref_sketches: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Hash-sorted (hashes, pos, strand, tid) over all target records."""
    if not ref_sketches:
        empty = np.empty(0, np.uint64)
        return empty, empty.astype(np.int32), empty.astype(np.uint8), empty.astype(np.int32)
    all_h = np.concatenate([sk[0] for sk in ref_sketches])
    all_p = np.concatenate([sk[1] for sk in ref_sketches])
    all_s = np.concatenate([sk[2] for sk in ref_sketches])
    all_t = np.concatenate(
        [np.full(sk[0].size, tid, np.int32) for tid, sk in enumerate(ref_sketches)]
    )
    order = np.argsort(all_h, kind="stable")
    return all_h[order], all_p[order], all_s[order], all_t[order]


def _backtrack(
    f: np.ndarray,
    p: np.ndarray,
    max_drop: int,
    min_sc: int,
    min_cnt: int,
):
    """mg_chain_backtrack; native kernel with the Python oracle below."""
    from pyani_plus_tpu_torch.native import mm2_backtrack_native

    result = mm2_backtrack_native(f, p, max_drop, min_sc, min_cnt)
    if result is None:  # pragma: no cover - no compiler
        result = _backtrack_py(f, p, max_drop, min_sc, min_cnt)
    return result


def _backtrack_py(  # noqa: PLR0913
    f: np.ndarray,
    p: np.ndarray,
    max_drop: int,
    min_sc: int,
    min_cnt: int,
):
    """mg_chain_backtrack (lchain.c): peaks by descending (f, index);
    each walk is truncated where the cumulative score falls more than
    ``max_drop`` below its running maximum (mg_chain_bk_end); anchors
    visited beyond the cut are consumed (t=2) without joining a chain.
    Returns [(score, anchor_idx_ascending)] in peak-score order.
    """
    n = f.size
    order = np.argsort(f, kind="stable")[::-1]
    t = np.zeros(n, dtype=np.int8)  # 0 free, 1 committed, 2 burned
    chains = []
    for peak in order:
        fpeak = int(f[peak])
        if fpeak < min_sc:
            break
        if t[peak]:
            continue
        # mg_chain_bk_end: find the cut predecessor
        i = int(peak)
        max_s = 0
        max_i = i
        while True:
            t[i] = 2
            i = int(p[i])
            s = fpeak if i < 0 else fpeak - int(f[i])
            if s > max_s:
                max_s = s
                max_i = i
            elif max_s - s > max_drop:
                break
            if i < 0 or t[i] != 0:
                break
        end_i = max_i
        walk = []
        i = int(peak)
        while i != end_i:
            walk.append(i)
            t[i] = 1
            i = int(p[i])
        sc = fpeak if end_i < 0 else fpeak - int(f[end_i])
        if walk and sc >= min_sc and len(walk) >= min_cnt:
            chains.append((sc, np.asarray(walk[::-1], dtype=np.int64)))
    return chains


def _chain_fill(x: np.ndarray, y: np.ndarray, k: int, max_dist: int, bw: int):
    """mg_chain_rmq heuristic fill -> (f, p)."""
    from pyani_plus_tpu_torch.native import mm2_chain_rmq2_native

    result = mm2_chain_rmq2_native(
        x, y, k, max_dist, RMQ_INNER_DIST, bw, CHAIN_GAP_SCALE * 0.01 * k,
        max_skip=MAX_SKIP, cap_rmq_size=RMQ_SIZE_CAP, pri_mode=RMQ_PRI_MODE,
        flags=RMQ_FLAGS,
    )
    if result is None:  # pragma: no cover - no compiler
        raise RuntimeError("mm2 native kernel unavailable")
    return result


def chain_anchors(x: np.ndarray, y: np.ndarray, k: int, *, pass2: bool = False):
    """One mg_chain_rmq pass + backtrack -> [(score, anchor_idx_asc)].

    ``pass2`` selects the long-join rescue geometry (max_dist = bw =
    bw_long) run on the anchors surviving a first pass; the first pass
    uses (max_gap, bw) with the asm presets' internal chain filters.
    """
    if pass2:
        f, p = _chain_fill(x, y, k, BW_LONG, BW_LONG)
        return _backtrack(f, p, BW_LONG, MIN_CHAIN_SCORE, MIN_CNT)
    f, p = _chain_fill(x, y, k, MAX_GAP, BW)
    return _backtrack(f, p, BW, PASS1_MIN_SC, PASS1_MIN_CNT)


def _mlen_blen(x: np.ndarray, y: np.ndarray, k: int) -> tuple[int, int]:
    """PAF nmatch / block length from chain anchors (hit.c accounting).

    >>> import numpy as np
    >>> _mlen_blen(np.array([100, 110, 160]), np.array([50, 60, 90]), 19)
    (48, 79)
    """
    dq = np.diff(y.astype(np.int64))
    dr = np.diff(x.astype(np.int64))
    dmin = np.minimum(dq, dr)
    mlen = int(k + np.minimum(dmin, k).sum())
    blen = int(k + np.maximum(dq, dr).sum())
    return mlen, blen


def _mapq(score: int, subsc: int, cnt: int) -> int:
    """minimap2 no-CIGAR mapq, reverse-derived from the fixtures.

    mapq = int(pen * 100 * (1 - subsc'/score)) clamped to [0, 60] with
    pen = min(1, 0.01*score, 0.1*cnt) and subsc' = max(subsc,
    MIN_CHAIN_SCORE) reproduces both viral datapoints exactly: the
    42-score/6-anchor chain gets 0.42*100*(2/42) = 2, the 38958-score
    chain saturates at 60.
    """
    sub = max(subsc, MIN_CHAIN_SCORE)
    if sub >= score:
        return 0
    pen = min(1.0, 0.01 * score, 0.1 * cnt)
    return max(0, min(60, int(pen * 100.0 * (1.0 - sub / score))))


def map_query(  # noqa: PLR0913
    ref_codes: np.ndarray,
    qry_codes: np.ndarray,
    k: int,
    w: int,
    ref_sketch=None,
) -> list[PafRecord]:
    """All primary PAF records of one query sequence vs one target."""
    return map_query_multi([ref_codes], qry_codes, k, w,
                           [ref_sketch] if ref_sketch is not None else None)


def map_query_multi(  # noqa: PLR0913
    ref_records: list[np.ndarray],
    qry_codes: np.ndarray,
    k: int,
    w: int,
    ref_sketches=None,
    ref_index=None,
    mid_occ: int | None = None,
    qry_sketch=None,
) -> list[PafRecord]:
    """Primary PAF records of one query vs a multi-sequence target index.

    Chains are built per target sequence (minimap2 never chains across
    sequences); the occurrence filter and the primary selection run over
    the combined index, as a single minimap2 .mmi would. Passing
    ``ref_sketches``/``ref_index``/``mid_occ`` reuses a prebuilt subject
    index across queries (the .mmi reuse of the reference invocation);
    ``qry_sketch`` reuses the query's own sketch across subjects.
    """
    if ref_sketches is None:
        ref_sketches = [sketch(rec, k, w) for rec in ref_records]
    qh, qp, qs = qry_sketch if qry_sketch is not None else sketch(qry_codes, k, w)
    qlen = int(qry_codes.size)
    index = build_index(ref_sketches) if ref_index is None else ref_index
    if mid_occ is None:
        mid_occ = mid_occ_threshold(index[0])

    regions: list[PafRecord] = []
    anchors = collect_anchors(index, qh, qp, qs, qlen, k, mid_occ)
    # pass 1: (max_gap, bw) chains per (target, strand) group
    pass1: list[tuple[int, int, int, np.ndarray]] = []
    for (tid, rel), (x, y) in anchors.items():
        for score, idx in chain_anchors(x, y, k):
            pass1.append((score, tid, rel, idx))
    pass1.sort(key=lambda c: -c[0])
    final: list[tuple[int, int, int, np.ndarray, np.ndarray]] = []
    do_rescue = False
    if len(pass1) > 1:
        # long-join rescue condition on the top chain's query span
        _, ttid, trel, tidx = pass1[0]
        cy = anchors[ttid, trel][1][tidx]
        span = int(cy[-1]) - int(cy[0])
        do_rescue = (
            qlen - span > RMQ_RESCUE_SIZE or span > qlen * RMQ_RESCUE_RATIO
        )
    if do_rescue:
        # re-chain the surviving anchors with bw_long window + width
        surviving: dict[tuple[int, int], list[np.ndarray]] = {}
        for _, tid, rel, idx in pass1:
            surviving.setdefault((tid, rel), []).append(idx)
        for (tid, rel), idx_list in surviving.items():
            x, y = anchors[tid, rel]
            take = np.sort(np.concatenate(idx_list))
            sx, sy = x[take], y[take]
            o = np.lexsort((sy, sx))
            sx, sy = sx[o], sy[o]
            for score, idx in chain_anchors(sx, sy, k, pass2=True):
                final.append((score, tid, rel, sx[idx], sy[idx]))
    else:
        for score, tid, rel, idx in pass1:
            if score >= MIN_CHAIN_SCORE and idx.size >= MIN_CNT:
                x, y = anchors[tid, rel]
                final.append((score, tid, rel, x[idx], y[idx]))
    for score, tid, rel, cx, cy in final:
        mlen, blen = _mlen_blen(cx, cy, k)
        qs0 = int(cy[0]) - (k - 1)
        qe0 = int(cy[-1]) + 1
        if rel == 1:  # flip back to the original query strand
            qstart, qend = qlen - qe0, qlen - qs0
        else:
            qstart, qend = qs0, qe0
        regions.append(
            PafRecord(
                qstart=qstart,
                qend=qend,
                strand="-" if rel else "+",
                tstart=int(cx[0]) - (k - 1),
                tend=int(cx[-1]) + 1,
                mlen=mlen,
                blen=blen,
                mapq=60,
                cnt=int(cx.size),
                score=score,
                subsc=0,
                tseq_id=tid,
            )
        )
    # primary selection by query-extent overlap (mm_set_parent)
    regions.sort(key=lambda r: -r.score)
    primaries: list[PafRecord] = []
    for reg in regions:
        parent = None
        for pri in primaries:
            ov = min(reg.qend, pri.qend) - max(reg.qstart, pri.qstart)
            if ov > 0 and ov > MASK_LEVEL * min(
                reg.qend - reg.qstart, pri.qend - pri.qstart
            ):
                parent = pri
                break
        if parent is None:
            primaries.append(reg)
        elif parent.subsc == 0:
            parent.subsc = reg.score
    for pri in primaries:
        pri.mapq = _mapq(pri.score, pri.subsc, pri.cnt)
    return primaries
