"""Fragment-to-genome mapping via winnowed MinHash (fastANI/MashMap core).

TPU-native replacement for the fastANI binary (SURVEY.md section 2.2).
Each 3 kb query fragment is sketched with winnowed minimizers (k=16,
w=24) and mapped against the reference genome's minimizer index; the
Jaccard similarity of the fragment A vs the reference substring starting
at position p is estimated with the winnowed-minhash estimator of the
MashMap paper:

    j(p) = |S(W(A) u W(B_p)) n W(A) n W(B_p)| / s

where W(A) is the fragment's sketch (s unique hashes), W(B_p) the
minimizer set of the reference substring [p, p+L), and S(.) the s
smallest hashes of the union. W(B_p) is derived *exactly* from the
whole-reference winnowing via pick runs: a minimizer belongs to the
substring iff its pick run intersects the substring's window steps
[p+w-1, p+L-k] (see ops/minimizers.py). j is maximised over all p
(evaluated at every step where window content changes, so the maximum
is exact). Jaccard converts to ANI via Mash distance
d = -1/k ln(2j/(1+j)).

Self-alignment therefore yields j = 1 exactly, reproducing fastANI's
100% self-ANI (and its < 100% anomaly on N-runs, since N bytes hash
literally). The round-3 semantics study (fixture .fastani outputs as
the oracle) pinned three further fastANI behaviours now implemented
here: the reported/binned position is the plateau END (the last optimal
window position), acceptance quantises the binomial upper quantile to
an integer sketch count (see identity_upper_bound), and the cgi stage
dedups by (ref sequence, position // fragLen) bin (ref_bin_filter).
Remaining deviation from the binary on the fixtures: bacterial
<= 0.20 ANI points / <= 30 retained fragments, viral <= 0.06 with
exact counts; the residue is fastANI's vendored-MashMap slide
evaluating a slightly different (sparser) anchor set, which its
outputs alone do not fully pin down (the MIBY01000011 self pair shows
its J dips below 1 where the exact window maximum cannot).

The per-candidate-region evaluation is a dense (events x hash-domain)
membership computation -- interval scatter, cumsum, rank reductions --
the exact shape that vectorises onto TPU; numpy is the host path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import ceil, exp, log

import numpy as np

from pyani_plus_tpu_torch.ops.minimizers import Minimizers, window_minimizers

KMER_SIZE = 16
WINDOW_SIZE = 24
FRAG_LEN = 3000
PERC_IDENTITY = 80.0  # fastANI default mapping identity cutoff


def md2j(d: float, k: int) -> float:
    """Mash distance -> Jaccard (MashMap Stat::md2j).

    >>> round(md2j(0.2, 16), 6)  # 80% identity at k=16
    0.020805
    >>> md2j(0.0, 16)
    1.0
    """
    return 1.0 / (2.0 * exp(d * k) - 1.0)


def j2md(j: float, k: int) -> float:
    """Jaccard -> Mash distance (MashMap Stat::j2md).

    >>> round(j2md(md2j(0.1, 16), 16), 12)
    0.1
    >>> j2md(0.0, 16)
    1.0
    """
    if j == 0:
        return 1.0
    return (-1.0 / k) * log(2.0 * j / (1.0 + j))


def n_window_steps(frag_len: int, k: int, w: int) -> int:
    """Number of window steps inside a fragment of length frag_len.

    >>> n_window_steps(3000, 16, 24)  # fastANI's countMinimizerWindows
    2962
    """
    return frag_len - k - w + 2


@dataclass
class RefIndex:
    """Minimizer pick-run index of one reference genome (all sequences).

    ``hashes_sorted``/``sorted_entry`` hold a one-time sort of the hash
    column so per-fragment L1 lookups are searchsorted joins instead of
    np.isin (which re-sorts the whole index per call);
    ``seq_bounds[sid]`` slices the per-sequence entry range (entries are
    stored grouped by sequence in position order).
    """

    seq_ids: np.ndarray  # int32 per record
    hashes: np.ndarray  # uint64
    first_steps: np.ndarray  # int64
    last_steps: np.ndarray  # int64
    seq_lengths: list[int]
    total_length: int
    k: int = KMER_SIZE
    w: int = WINDOW_SIZE
    hashes_sorted: np.ndarray | None = None
    sorted_entry: np.ndarray | None = None
    seq_bounds: dict[int, tuple[int, int]] | None = None

    def __post_init__(self) -> None:
        if self.hashes_sorted is None:
            self.hashes = np.ascontiguousarray(self.hashes, dtype=np.uint64)
            self.first_steps = np.ascontiguousarray(
                self.first_steps, dtype=np.int64
            )
            self.last_steps = np.ascontiguousarray(
                self.last_steps, dtype=np.int64
            )
            self.seq_ids = np.ascontiguousarray(self.seq_ids, dtype=np.int32)
            order = np.argsort(self.hashes, kind="stable")
            self.hashes_sorted = self.hashes[order]
            self.sorted_entry = np.ascontiguousarray(order, dtype=np.int64)
            bounds: dict[int, tuple[int, int]] = {}
            if self.seq_ids.size:
                change = np.nonzero(np.diff(self.seq_ids))[0] + 1
                starts = np.concatenate(([0], change))
                ends = np.concatenate((change, [self.seq_ids.size]))
                for s, e in zip(starts, ends):
                    bounds[int(self.seq_ids[s])] = (int(s), int(e))
            self.seq_bounds = bounds
            sids = sorted(bounds)
            self.seq_lo_arr = np.array(
                [bounds[sid][0] for sid in sids], dtype=np.int64
            )
            self.seq_hi_arr = np.array(
                [bounds[sid][1] for sid in sids], dtype=np.int64
            )
            self.seq_ids_arr = np.array(sids, dtype=np.int32)

    @classmethod
    def build(
        cls,
        sequences: list[bytes | np.ndarray],
        k: int = KMER_SIZE,
        w: int = WINDOW_SIZE,
    ) -> "RefIndex":
        seq_ids, hashes, firsts, lasts, lengths = [], [], [], [], []
        for sid, seq in enumerate(sequences):
            lengths.append(len(seq))
            mins = window_minimizers(seq, k, w)
            if mins.count:
                seq_ids.append(np.full(mins.count, sid, dtype=np.int32))
                hashes.append(mins.hashes)
                firsts.append(mins.first_steps)
                lasts.append(mins.last_steps)
        if hashes:
            return cls(
                seq_ids=np.concatenate(seq_ids),
                hashes=np.concatenate(hashes),
                first_steps=np.concatenate(firsts),
                last_steps=np.concatenate(lasts),
                seq_lengths=lengths,
                total_length=sum(lengths),
                k=k,
                w=w,
            )
        return cls(
            seq_ids=np.empty(0, np.int32),
            hashes=np.empty(0, np.uint64),
            first_steps=np.empty(0, np.int64),
            last_steps=np.empty(0, np.int64),
            seq_lengths=lengths,
            total_length=sum(lengths),
            k=k,
            w=w,
        )


@dataclass
class FragmentMapping:
    """Best mapping of one query fragment."""

    fragment_id: int
    ref_seq_id: int
    ref_step: int  # window-step of the LAST optimal window (plateau end)
    shared: int
    sketch_size: int
    identity: float  # percent nucleotide identity estimate

    def ref_wpos(self, w: int = WINDOW_SIZE) -> int:
        """Plateau end in windowId units (~ base offset of window start).

        This is the position fastANI reports and its cgi stage bins by
        (refStartPos // fragLen); validated against the fixture self-pair
        retained counts (1820/1825 etc.), which only reproduce when the
        binned position is the TRAILING optimal window position.
        """
        return self.ref_step - (w - 1)


CONFIDENCE = 0.9  # MashMap confidence interval for acceptance bounds


def identity_upper_bound(
    shared: int, s: int, k: int, ci: float = CONFIDENCE
) -> float:
    """Upper bound (%) of the CI on the identity estimate.

    MashMap accepts a mapping when this bound crosses the identity
    threshold, not when the point estimate does (Stat::md_lower_bound
    at ci=0.9) -- this is why fastANI keeps sub-threshold fragments on
    divergent genomes (e.g. 877 of 1825 at mean ANI 82.9 on the
    bacterial fixtures' NC_010338 vs NC_002696, where a point-estimate
    gate keeps only 738 at mean 84.5).

    The bound is the INTEGER-QUANTISED normal approximation of the
    binomial upper quantile -- the boost-free replacement fastANI ships:
    x = max(ceil(s*j + z*sqrt(s*j*(1-j))), 1) shared sketches at the
    one-sided z for ci=0.9 (z = 1.6449), then j_hi = x/s.  The ceil
    quantisation is what admits shared=2 at s~238 (j_hi = 5/s) while
    rejecting shared=1, which the fixture retained-fragment counts
    require: the continuous bound leaves bacterial counts 65-84 low and
    ANI up to +0.76 high, the ceil bound lands within 30 fragments and
    0.20 ANI points on every fixture pair (round-3 semantics study;
    see CLAUDE.md fastANI notes).
    """
    import math

    j_obs = min(1.0, shared / s)
    z = {0.9: 1.6449}.get(ci)
    if z is None:  # pragma: no cover - non-default ci
        from scipy.stats import norm

        z = float(norm.ppf(1.0 - (1.0 - ci) / 2.0))
    x = max(
        math.ceil(s * j_obs + z * math.sqrt(s * j_obs * (1.0 - j_obs))), 1
    )
    j_hi = min(1.0, x / s)
    return 100.0 * (1.0 - j2md(j_hi, k))


@lru_cache(maxsize=4096)
def estimate_minimum_hits_relaxed(s: int, k: int, perc_identity: float) -> int:
    """L1 candidate threshold: relaxed lower bound on shared minimizers.

    Strict estimate is ceil(s * j(tau)); relaxation takes the lower 90%
    binomial confidence bound (MashMap Stat::estimateMinimumHitsRelaxed).
    Memoised: (s, k, tau) repeats for every fragment of a run and the
    scipy binom.ppf call was ~20% of a bacterial pair's mapping time.
    """
    j = md2j(1.0 - perc_identity / 100.0, k)
    strict = ceil(s * j)
    relaxed = _binom_ppf(0.1, s, j) if s > 0 else 0
    return max(1, min(strict, relaxed))


def _binom_ppf(q: float, n: int, p: float) -> int:
    """Smallest m with Binomial(n, p) CDF(m) >= q.

    Direct pmf-recursion CDF walk, verified to return exactly
    ``int(scipy.stats.binom.ppf(q, n, p))`` over the full parameter
    domain this module uses (k 12..16, tau 75..90, s 1..3000; 36k
    combos, zero mismatches) -- replacing the scipy import, whose
    first-use cost (~2.6 s) dominated a worker's first fastANI pair.
    """
    if p <= 0.0 or n == 0:
        return 0
    if p >= 1.0:
        return n
    pmf = (1.0 - p) ** n
    if pmf == 0.0:  # pragma: no cover - underflow outside our domain
        from scipy.stats import binom

        return int(binom.ppf(q, n, p))
    cdf = pmf
    m = 0
    ratio = p / (1.0 - p)
    while cdf < q and m < n:
        pmf *= (n - m) / (m + 1.0) * ratio
        m += 1
        cdf += pmf
    return m


def _evaluate_region(  # noqa: PLR0913
    query_hashes_sorted: np.ndarray,  # unique uint64, ascending
    entry_hash: np.ndarray,  # region run hashes
    entry_first: np.ndarray,  # region run first steps
    entry_last: np.ndarray,  # region run last steps
    event_t: np.ndarray,  # window anchor steps to evaluate (ascending)
    w_steps: int,
    s: int,
    region_b: int | None = None,
) -> tuple[int, int, int]:
    """Max top-s-union shared count over the event windows ->
    (shared, first_t, plateau_end).

    A run is inside window anchored at t iff it intersects steps
    [t, t + w_steps - 1], i.e. t in [first - w_steps + 1, last].
    ``plateau_end`` is the last integer anchor still achieving the
    maximum (the step function is constant between events), clipped to
    ``region_b``. Dispatches to the native Fenwick-sweep kernel when
    available (O((runs+events) log domain) vs this dense
    O(events x domain) oracle; bit-identical, fuzz-tested).
    """
    from pyani_plus_tpu_torch.native import fastani_eval_region_native

    res = fastani_eval_region_native(
        query_hashes_sorted, entry_hash, entry_first, entry_last,
        event_t, w_steps, s, region_b,
    )
    if res is not None:
        return res
    return _evaluate_region_numpy(
        query_hashes_sorted, entry_hash, entry_first, entry_last,
        event_t, w_steps, s, region_b,
    )


def _evaluate_region_numpy(  # noqa: PLR0913
    query_hashes_sorted: np.ndarray,
    entry_hash: np.ndarray,
    entry_first: np.ndarray,
    entry_last: np.ndarray,
    event_t: np.ndarray,
    w_steps: int,
    s: int,
    region_b: int | None = None,
) -> tuple[int, int, int]:
    """Numpy oracle for :func:`_evaluate_region` (kept for parity tests)."""
    if region_b is None:
        region_b = int(event_t[-1]) if event_t.size else 0
    domain = np.union1d(query_hashes_sorted, entry_hash)  # sorted unique
    in_query = np.isin(domain, query_hashes_sorted, assume_unique=True)
    n_events = event_t.size

    lo = np.searchsorted(event_t, entry_first - w_steps + 1, side="left")
    hi = np.searchsorted(event_t, entry_last, side="right")
    hash_idx = np.searchsorted(domain, entry_hash)

    delta = np.zeros((n_events + 1, domain.size), dtype=np.int32)
    np.add.at(delta, (lo, hash_idx), 1)
    np.add.at(delta, (hi, hash_idx), -1)
    ref_member = np.cumsum(delta[:-1], axis=0) > 0  # (events, D)

    union_member = ref_member | in_query[None, :]
    ranks = np.cumsum(union_member, axis=1)  # 1-based rank of each hash
    within_s = ranks <= s
    shared = (ref_member & in_query[None, :] & within_s).sum(axis=1)
    best = int(shared.argmax())
    last = int(np.flatnonzero(shared == shared[best])[-1])
    plateau_end = int(event_t[last + 1]) - 1 if last + 1 < n_events else region_b
    return int(shared[best]), int(event_t[best]), plateau_end


def map_fragment(  # noqa: PLR0913, C901
    frag_minimizers: Minimizers,
    ref: RefIndex,
    frag_len: int = FRAG_LEN,
    k: int = KMER_SIZE,
    w: int = WINDOW_SIZE,
    perc_identity: float = PERC_IDENTITY,
    fragment_id: int = 0,
) -> FragmentMapping | None:
    """Map one fragment against a reference index; return the best mapping."""
    if frag_minimizers.count == 0 or ref.hashes.size == 0:
        return None
    query_hashes = np.unique(frag_minimizers.hashes)
    s = int(query_hashes.size)
    w_steps = n_window_steps(frag_len, k, w)

    from pyani_plus_tpu_torch.native import fastani_map_fragment_native

    native = fastani_map_fragment_native(
        query_hashes,
        ref.hashes,
        ref.first_steps,
        ref.last_steps,
        ref.seq_ids,
        ref.hashes_sorted,
        ref.sorted_entry,
        ref.seq_lo_arr,
        ref.seq_hi_arr,
        ref.seq_ids_arr,
        w_steps,
        s,
        frag_len,
        w - 1,
    )
    if native is not None:
        best_shared, best_t, best_seq = native
        return _finish_mapping(
            best_shared, best_t, best_seq, s, k, perc_identity, fragment_id
        )
    best_shared, best_t, best_seq = _search_mappings_numpy(
        query_hashes, ref, w_steps, s, frag_len, w - 1
    )
    return _finish_mapping(
        best_shared, best_t, best_seq, s, k, perc_identity, fragment_id
    )


def _search_mappings_numpy(  # noqa: PLR0913
    query_hashes: np.ndarray,
    ref: RefIndex,
    w_steps: int,
    s: int,
    frag_span: int,
    min_anchor: int,
) -> tuple[int, int, int]:
    """Numpy oracle for the native fragment L2 search (parity-tested).

    Candidate anchor regions are the merged per-hit intervals
    [max(min_anchor, t - frag_span + 1), t] -- fastANI's L1 with
    frag_span = Q.len (the acceptance gate does the filtering); the
    result position is the plateau END of the best region (see
    FragmentMapping.ref_wpos).
    """
    # L1: every index run whose hash is in the fragment sketch
    # (searchsorted join against the pre-sorted hash column)
    lo = np.searchsorted(ref.hashes_sorted, query_hashes, side="left")
    hi = np.searchsorted(ref.hashes_sorted, query_hashes, side="right")
    counts = hi - lo
    nz = counts > 0
    if not nz.any():
        return 0, -1, -1
    entry_idx = ref.sorted_entry[
        np.concatenate(
            [np.arange(c) + start for c, start in zip(counts[nz], lo[nz])]
        )
    ]
    hit_seq = ref.seq_ids[entry_idx]
    hit_t = ref.first_steps[entry_idx]
    order = np.lexsort((hit_t, hit_seq))
    hit_seq, hit_t = hit_seq[order], hit_t[order]

    best_shared, best_t, best_seq = 0, -1, -1
    for sid in np.unique(hit_seq):
        t_hits = hit_t[hit_seq == sid]
        starts = np.maximum(t_hits - frag_span + 1, min_anchor)
        ends = np.maximum(t_hits, starts)
        regions: list[tuple[int, int]] = []
        for a, b in zip(starts, ends):
            a, b = int(a), int(b)  # noqa: PLW2901
            if regions and a <= regions[-1][1]:
                regions[-1] = (regions[-1][0], max(regions[-1][1], b))
            else:
                regions.append((a, b))

        b_lo, b_hi = ref.seq_bounds[int(sid)]
        seq_hash = ref.hashes[b_lo:b_hi]
        seq_first = ref.first_steps[b_lo:b_hi]
        seq_last = ref.last_steps[b_lo:b_hi]
        for a, b in regions:
            # Runs that can appear in any window anchored in [a, b]
            run_mask = (seq_last >= a) & (seq_first <= b + w_steps - 1)
            if not run_mask.any():
                continue
            e_hash = seq_hash[run_mask]
            e_first = seq_first[run_mask]
            e_last = seq_last[run_mask]
            # Events: all content-change anchors within [a, b]
            events = np.unique(
                np.clip(
                    np.concatenate([e_first - w_steps + 1, e_last + 1, [a]]), a, b
                )
            )
            shared, _t_first, t_end = _evaluate_region(
                query_hashes, e_hash, e_first, e_last, events, w_steps, s, b
            )
            if shared > best_shared:
                best_shared, best_t, best_seq = shared, t_end, int(sid)

    return best_shared, best_t, best_seq


def _finish_mapping(  # noqa: PLR0913
    best_shared: int,
    best_t: int,
    best_seq: int,
    s: int,
    k: int,
    perc_identity: float,
    fragment_id: int,
) -> FragmentMapping | None:
    """Identity estimate + CI acceptance on the best window found."""
    if best_shared == 0:
        return None
    j = min(1.0, best_shared / s)
    identity = 100.0 * (1.0 - j2md(j, k))
    if identity_upper_bound(best_shared, s, k) < perc_identity:
        # CI-based acceptance (see identity_upper_bound): the point
        # estimate may be below the threshold, the reported identity is
        # still the point estimate.
        return None
    return FragmentMapping(
        fragment_id=fragment_id,
        ref_seq_id=best_seq,
        ref_step=best_t,
        shared=best_shared,
        sketch_size=s,
        identity=identity,
    )


def ref_bin_filter(
    mappings: list[FragmentMapping],
    fragsize: int = FRAG_LEN,
    w: int = WINDOW_SIZE,
) -> list[FragmentMapping]:
    """fastANI cgi.hpp's reference-bin dedup (computeGenomeCoreIdentity).

    After picking the best mapping per query fragment, fastANI removes
    redundant mappings where multiple query fragments map to the same
    reference region: mappings bin by (ref sequence,
    reported_position // fragLen) and only the highest-identity mapping
    per bin is retained (ties: lowest fragment id, matching the
    iteration order of its max_element over the bin).  This dedup is
    what produces the fixture self-pair retained counts (1820/1825,
    1338/1338, 1346/1347, 1549/1551 -- all reproduced).
    """
    rows = sorted(
        (mp.ref_seq_id, mp.ref_wpos(w) // fragsize, -mp.identity,
         mp.fragment_id, mp)
        for mp in mappings
    )
    kept: list[FragmentMapping] = []
    seen: set[tuple[int, int]] = set()
    for seq_id, bin_id, _negi, _fid, mp in rows:
        if (seq_id, bin_id) in seen:
            continue
        seen.add((seq_id, bin_id))
        kept.append(mp)
    kept.sort(key=lambda mp: mp.fragment_id)
    return kept
