"""Suffix array, LCP, and maximal (unique) match enumeration.

The seeding stage of the nucmer replacement (SURVEY.md section 2.2 row
nucmer): maximal unique matches (MUMs, ``--mum``: unique in both
sequences) or maximal matches (``--maxmatch``, dnadiff) of length >=
minmatch between a reference and a query, found with a prefix-doubling
suffix array + Kasai LCP over the concatenation -- all numpy sorts, so
multi-megabase genomes index in seconds.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from pyani_plus_tpu_torch.utils import spans


class SeedIndexCache:
    """Process-wide LRU of per-sequence seeding structures.

    ANIm's MUM seeding needs, per (subject, query, strand): the
    subject's suffix-automaton index and the query's reverse-complement
    codes.  Both depend on a single sequence, so caching them here
    turns an all-vs-all run from O(pairs) index builds into O(genomes):
    the subject index is reused down a whole column and each query's
    minus strand across rows.

    Keys are ``id(codes)`` -- safe because every entry keeps a
    reference to its codes array, pinning the id for the entry's
    lifetime (genome records are held by the run context anyway).
    Builds are de-duplicated across threads with per-key events.
    """

    #: Rough bytes per automaton state: 32 B packed hot block (stride-8
    #: nxt/link/len) + fpos/clone/tour_lo/tour_hi/pos_list side arrays.
    _SAM_BYTES_PER_STATE = 56

    def __init__(
        self,
        sam_capacity: int = 8,
        rep_capacity: int = 64,
        sam_budget_bytes: int = 1_500_000_000,
    ) -> None:
        self._lock = threading.Lock()
        self._building: dict[tuple, threading.Event] = {}
        self._sam: OrderedDict = OrderedDict()
        self._rc: OrderedDict = OrderedDict()
        self.sam_capacity = sam_capacity
        self.rep_capacity = rep_capacity
        self.sam_budget_bytes = sam_budget_bytes
        self._sam_bytes = 0

    @classmethod
    def _entry_bytes(cls, value) -> int:
        states = getattr(value, "states", None)
        if states:
            return int(states) * cls._SAM_BYTES_PER_STATE
        return 0

    def _get_or_build(self, table, capacity, key, codes, build):
        while True:
            with self._lock:
                entry = table.get(key)
                if entry is not None:
                    table.move_to_end(key)
                    return entry[1]
                event = self._building.get(key)
                if event is None:
                    event = threading.Event()
                    self._building[key] = event
                    break
            event.wait()
        try:
            value = build(codes)
            with self._lock:
                table[key] = (codes, value)
                if table is self._sam:
                    self._sam_bytes += self._entry_bytes(value)
                # Evict by entry count AND (for automata) approximate byte
                # budget: one 5.5 Mb subject pins ~0.5 GB, so a pure entry
                # cap could hold gigabytes of bacterial indexes forever.
                # Always keep the newest entry even if it alone exceeds
                # the budget (it is about to be used).
                while len(table) > capacity or (
                    table is self._sam
                    and len(table) > 1
                    and self._sam_bytes > self.sam_budget_bytes
                ):
                    _, (_, old) = table.popitem(last=False)
                    if table is self._sam:
                        self._sam_bytes -= self._entry_bytes(old)
        finally:
            with self._lock:
                del self._building[key]
            event.set()
        return value

    def sam_for(self, codes: np.ndarray):
        """Native suffix-automaton index of ``codes`` (subject role)."""
        from pyani_plus_tpu_torch.native import sam_build_native

        return self._get_or_build(
            self._sam,
            self.sam_capacity,
            ("sam", id(codes)),
            codes,
            sam_build_native,
        )

    def rc_for(self, codes: np.ndarray) -> np.ndarray:
        """Reverse-complement codes of ``codes`` (minus-strand query)."""
        from pyani_plus_tpu_torch.genomes import complement_codes

        return self._get_or_build(
            self._rc,
            self.rep_capacity,
            ("rc", id(codes)),
            codes,
            lambda c: complement_codes(c)[::-1].copy(),
        )

    def clear(self) -> None:
        with self._lock:
            self._sam.clear()
            self._rc.clear()
            self._sam_bytes = 0


SEED_CACHE = SeedIndexCache(
    sam_capacity=int(os.environ.get("PYANI_TPU_SAM_CACHE", "8")),
    rep_capacity=int(os.environ.get("PYANI_TPU_REP_CACHE", "64")),
    sam_budget_bytes=int(
        float(os.environ.get("PYANI_TPU_SAM_CACHE_MB", "1500")) * 1e6
    ),
)


_NATIVE_SAM_OK: bool | None = None


def seed_index_enabled() -> bool:
    """Whether the streamed MUM path (native suffix automaton) is on."""
    global _NATIVE_SAM_OK
    if os.environ.get("PYANI_TPU_MUM_INDEX", "1") == "0":
        return False
    if _NATIVE_SAM_OK is None:
        from pyani_plus_tpu_torch.native import sam_build_native

        _NATIVE_SAM_OK = sam_build_native(np.empty(0, np.uint8)) is not None
    return _NATIVE_SAM_OK


def suffix_array(data: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (native radix rounds, numpy fallback)."""
    n = data.size
    if n == 0:
        return np.empty(0, np.int64)
    from pyani_plus_tpu_torch.native import suffix_array_native

    native = suffix_array_native(data)
    if native is not None:
        return native
    rank = np.asarray(data, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        # Sort by (rank[i], rank[i+k]) pairs
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        # Recompute ranks
        new_rank = np.empty(n, dtype=np.int64)
        r_ord = rank[order]
        s_ord = second[order]
        changed = np.empty(n, dtype=bool)
        changed[0] = True
        changed[1:] = (r_ord[1:] != r_ord[:-1]) | (s_ord[1:] != s_ord[:-1])
        new_rank[order] = np.cumsum(changed) - 1
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order
        k *= 2
        if k >= n:
            return order[np.argsort(rank[order], kind="stable")]  # pragma: no cover


def lcp_array(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP: lcp[i] = LCP(suffix sa[i-1], suffix sa[i]); lcp[0]=0."""
    n = data.size
    lcp = np.zeros(n, dtype=np.int64)
    if n == 0:
        return lcp
    from pyani_plus_tpu_torch.native import kasai_lcp_native

    native = kasai_lcp_native(data, sa)
    if native is not None:
        return native
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            max_h = n - max(i, j)
            while h < max_h and data[i + h] == data[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def _lcp_kasai_fast(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Vectorised-ish Kasai via comparing shifted arrays in chunks."""
    # The plain Python Kasai above is O(n) but slow in Python for Mb
    # inputs; this variant vectorises the common case where most LCP
    # extensions are short by seeding with a batch comparison.
    return lcp_array(data, sa)


def mum_matches_indexed(
    index,
    ref: np.ndarray,
    qry: np.ndarray,
    min_len: int = 20,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MUMs of qry vs an indexed ref -- same set as ``maximal_matches``
    with ``unique_ref=unique_qry=True``, streamed in O(|qry|).

    ``index`` is a native ``SamIndex`` built from ``ref`` (suffix
    automaton over the reversal).

    Why this is complete: a MUM starting at query position j must have
    length exactly ms[j] (the longest prefix of qry[j:] present in
    ref) -- a shorter right-maximal match would need a second ref
    occurrence of its prefix, contradicting ref-uniqueness.  So per
    start there is at most one candidate, at full depth with a
    singleton ref occurrence.

    Query-side uniqueness needs no query index: if candidate S (ref
    start i, length L) occurs again in qry at j', then ms[j'] >= L and
    the longer string there still occurs exactly once in ref -- at the
    same start i (S is its prefix and S is unique).  So every extra
    occurrence of S surfaces as another candidate in the same ref-start
    group, with length >= L; a candidate is unique in qry iff it is the
    strict maximum length of its group.  (A shorter group member never
    witnesses a repeat of a longer one: only its prefix repeats.)

    The stream runs in interleaved lanes (``sam_stream_ms_lanes``, exact
    to the position); the group rule and left-maximality then run in one
    native linear pass over its arrays (``sam_select_mums``), in ascending
    ref start. The counters ``anim.seed_lanes`` and ``anim.seed_rewalked``
    count the stream's lanes and the positions its boundary fix-up
    streamed again, ``anim.seed_candidates`` the candidates the selection
    took in.
    """
    from pyani_plus_tpu_torch.native import sam_select_mums_native, sam_stream_ms_lanes_native

    ms_len, ref_start, lanes, rewalked = sam_stream_ms_lanes_native(index, qry)
    if lanes > 1:
        spans.count("anim.seed_lanes", lanes)
        spans.count("anim.seed_rewalked", rewalked)
    i, j, length, candidates = sam_select_mums_native(ms_len, ref_start, ref, qry, min_len)
    spans.count("anim.seed_candidates", candidates)
    return i, j, length


def max_matches_indexed(
    index,
    ref: np.ndarray,
    qry: np.ndarray,
    min_len: int = 20,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All maximal matches of qry vs an indexed ref -- same set as
    ``maximal_matches`` with ``unique_ref=unique_qry=False`` (nucmer
    --maxmatch, the dnadiff seeding mode), streamed output-sensitively.

    The native side emits every right-maximal (ref_start, qry_start,
    exact pairwise LCP) triple with LCP >= min_len by walking the
    matched state's suffix-link chain and enumerating endpos set
    differences via an Euler tour of the link tree; left-maximality is
    filtered here (vectorised), mirroring the oracle's rule that
    ambiguous left characters never block maximality.
    """
    from pyani_plus_tpu_torch.native import sam_stream_maxmatch_native

    i, j, length = sam_stream_maxmatch_native(index, qry, min_len)
    if not i.size:
        return (np.empty(0, np.int64),) * 3
    left_r = ref[np.maximum(i - 1, 0)]
    left_q = qry[np.maximum(j - 1, 0)]
    left_max = (
        (j == 0)
        | (i == 0)
        | (left_r != left_q)
        | (left_r >= 4)  # ambiguous bases never equal anything
    )
    keep = np.nonzero(left_max)[0]
    return i[keep], j[keep], length[keep]


def maximal_matches(  # noqa: C901, PLR0912
    ref: np.ndarray,
    qry: np.ndarray,
    min_len: int = 20,
    *,
    unique_ref: bool = True,
    unique_qry: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Maximal matches of length >= min_len between two code arrays.

    Returns (ref_pos, qry_pos, length) arrays, 0-based. With both
    ``unique_*`` True this is nucmer's ``--mum`` (matches unique in ref
    AND qry); with both False it is ``--maxmatch``.

    Codes must be < 16; internal sentinels 96/97/98 separate and
    terminate the sequences (distinct so no cross-boundary matches).
    """
    n_ref, n_qry = ref.size, qry.size
    if n_ref == 0 or n_qry == 0 or min(n_ref, n_qry) < min_len:
        return (np.empty(0, np.int64),) * 3
    text = np.concatenate(
        [
            ref.astype(np.int64),
            [96],
            qry.astype(np.int64),
            [97],
        ]
    )
    # Ambiguous bases (code >= 4) must not match anything, including other
    # Ns (MUMmer semantics -- this is what makes N-runs break self-matches,
    # reference test_self_vs_self.py). Give each one a unique symbol.
    ambiguous = np.nonzero((text >= 4) & (text < 90))[0]
    if ambiguous.size:
        text[ambiguous] = 100 + np.arange(ambiguous.size)
    n = text.size
    sa = suffix_array(text)
    lcp = lcp_array(text, sa)

    is_qry = sa > n_ref  # suffix starts inside qry (after the separator)
    # Left characters for left-maximality (sentinel 98 at string start)
    left = np.where(sa > 0, text[np.maximum(sa - 1, 0)], 98)
    # Positions: ref offset = sa; qry offset = sa - n_ref - 1

    out_r, out_q, out_l = [], [], []

    if unique_ref and unique_qry:
        # MUM: adjacent pair (i, i+1) with one suffix from each sequence,
        # match length L = lcp[i+1] >= min_len, uniqueness via
        # lcp[i] < L and lcp[i+2] < L, left-maximality via differing
        # left characters.
        L = lcp[1:]  # match length of pair (i, i+1)
        cross = is_qry[:-1] != is_qry[1:]
        lcp_prev = lcp[:-1]
        lcp_next = np.concatenate([lcp[2:], [0]])
        good = (
            cross
            & (L >= min_len)
            & (lcp_prev < L)
            & (lcp_next < L)
            & (left[:-1] != left[1:])
        )
        idx = np.nonzero(good)[0]
        for i in idx:
            a, b = sa[i], sa[i + 1]
            if is_qry[i]:
                a, b = b, a
            out_r.append(a)
            out_q.append(b - n_ref - 1)
            out_l.append(L[i])
    else:
        # Maximal matches: for every pair of suffixes (one per sequence)
        # sharing a prefix >= min_len that is left-maximal. Enumerate via
        # LCP-interval stack would be ideal; a simpler O(pairs) sweep over
        # SA neighbourhoods suffices for the genome sizes here.
        # For each adjacent run sharing lcp >= min_len, cross pairs are
        # candidate matches with length = min lcp between them; maximality
        # right: length is the full common prefix extent of the pair;
        # left: left chars differ.
        # To bound work we enumerate only pairs whose match length equals
        # the minimum LCP on the path (standard adjacent-pair argument
        # misses non-adjacent maximal pairs, so walk runs).
        start = 0
        while start < n:
            end = start
            while end + 1 < n and lcp[end + 1] >= min_len:
                end += 1
            if end > start:
                block_idx = np.arange(start, end + 1)
                refs = block_idx[~is_qry[block_idx]]
                qrys = block_idx[is_qry[block_idx]]
                if refs.size and qrys.size:
                    # pairwise match length = min lcp over the span
                    for ri in refs:
                        for qi in qrys:
                            lo, hi = (ri, qi) if ri < qi else (qi, ri)
                            ml = int(lcp[lo + 1 : hi + 1].min())
                            if ml < min_len:
                                continue
                            if left[ri] == left[qi] and left[ri] != 98:
                                continue  # not left-maximal
                            out_r.append(sa[ri])
                            out_q.append(sa[qi] - n_ref - 1)
                            out_l.append(ml)
            start = end + 1
    if not out_r:
        return (np.empty(0, np.int64),) * 3
    return (
        np.asarray(out_r, dtype=np.int64),
        np.asarray(out_q, dtype=np.int64),
        np.asarray(out_l, dtype=np.int64),
    )
