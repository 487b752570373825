"""Native (C++) host-side kernels, loaded via ctypes with lazy build.

The card owns the batched scoring math; these cover the host stages of
the four ported methods: sketch hashing (``sketch.cpp``), suffix
automaton seeding (``suffix.cpp``), clustering and chain DPs
(``chain.cpp``), the banded affine DP (``band.cpp``), the local
alignment score and stats DPs (``align.cpp``) and the seed join
(``seedjoin.cpp``). Each library is built with g++ on first use through
``ops/_build.py`` (source hash in the file name, written under a private
name and renamed, one lock held across build and load), so concurrent
threads and processes all get the finished library. Absence of a
compiler degrades gracefully to the numpy implementations: every
wrapper then returns ``None`` (or ``False``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from pyani_plus_tpu_torch.ops._build import load_host_library


def _bound(name: str, bind) -> ctypes.CDLL | None:
    """The host library ``name`` with its argument types set, or None."""
    lib = load_host_library(name)
    if lib is not None and not getattr(lib, "_bound", False):
        bind(lib)  # idempotent, so a second thread binding again is harmless
        lib._bound = True
    return lib


def _bind_sketch(lib) -> None:
    lib.sketch_codes.restype = ctypes.c_int64
    lib.sketch_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
    ]
    lib.hash_codes.restype = ctypes.c_int64
    lib.hash_codes.argtypes = lib.sketch_codes.argtypes[:4] + [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
    ]


def _load():
    return _bound("sketch", _bind_sketch)


def have_native() -> bool:
    return _load() is not None


def sketch_codes_native(
    codes: np.ndarray, k: int, max_hash: int, seed: int = 42
) -> np.ndarray | None:
    """Retained canonical-kmer hashes (<= max_hash), or None if unavailable.

    Output is in window order, NOT deduped/sorted (same contract as
    ops.kmers.canonical_kmer_hashes + filter).
    """
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.size
    if n < k:
        return np.empty(0, np.uint64)
    # Capacity: generous bound on retained hashes
    if max_hash >= 2**63:
        cap = n
    else:
        expected = int(n * (max_hash / 2.0**64) * 4) + 4096
        cap = min(n, expected)
    out = np.empty(cap, dtype=np.uint64)
    count = lib.sketch_codes(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        k,
        ctypes.c_uint64(max_hash),
        seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cap,
    )
    if count == cap and cap < n:  # pragma: no cover - undersized capacity
        out = np.empty(n, dtype=np.uint64)
        count = lib.sketch_codes(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            k,
            ctypes.c_uint64(max_hash),
            seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n,
        )
    return out[:count].copy()


def _bind_align(lib) -> None:
    lib.local_align_stats.restype = ctypes.c_int
    lib.local_align_stats.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.local_align_score.restype = ctypes.c_int32
    lib.local_align_score.argtypes = lib.local_align_stats.argtypes[:8]


def _load_align():
    return _bound("align", _bind_align)


def local_align_stats_native(  # noqa: PLR0913
    query: np.ndarray,
    subject: np.ndarray,
    reward: int,
    penalty: int,
    gap_open: int,
    gap_extend: int,
):
    """Native local alignment stats tuple, or None if unavailable.

    Returns (score, length, matches, mismatches, gaps, gap_opens,
    q_start, q_end, s_start, s_end) or False when no positive alignment.
    """
    lib = _load_align()
    if lib is None:
        return None
    query = np.ascontiguousarray(query, dtype=np.uint8)
    subject = np.ascontiguousarray(subject, dtype=np.uint8)
    out = np.zeros(10, dtype=np.int64)
    ok = lib.local_align_stats(
        query.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        query.size,
        subject.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        subject.size,
        reward,
        penalty,
        gap_open,
        gap_extend,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if not ok:
        return False
    return tuple(int(v) for v in out)


def local_align_score_native(  # noqa: PLR0913
    query: np.ndarray,
    subject: np.ndarray,
    reward: int,
    penalty: int,
    gap_open: int,
    gap_extend: int,
) -> int | None:
    """Best local alignment score only (no traceback), or None."""
    lib = _load_align()
    if lib is None:
        return None
    query = np.ascontiguousarray(query, dtype=np.uint8)
    subject = np.ascontiguousarray(subject, dtype=np.uint8)
    return int(
        lib.local_align_score(
            query.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            query.size,
            subject.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            subject.size,
            reward,
            penalty,
            gap_open,
            gap_extend,
        )
    )




def _bind_seedjoin(lib) -> None:
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.seed_join_count_sorted.restype = ctypes.c_int64
    lib.seed_join_count_sorted.argtypes = [
        p64, ctypes.c_int64, p64, ctypes.c_int64,
    ]
    lib.seed_join_diags_sorted.restype = ctypes.c_int64
    lib.seed_join_diags_sorted.argtypes = [
        p64, p64, ctypes.c_int64,
        p64, p64, p64, ctypes.c_int64,
        ctypes.c_int64, p64, p64, ctypes.c_int64,
    ]
    lib.seed_sort_rows.restype = None
    lib.seed_sort_rows.argtypes = [p64, p64, p64, ctypes.c_int64]


def _load_seedjoin():
    return _bound("seedjoin", _bind_seedjoin)


def seed_sort_rows_native(
    q_vals: np.ndarray, q_within: np.ndarray, q_frag: np.ndarray
) -> bool:
    """Stable in-place sort of parallel int64 rows by ``q_vals``.

    Two 11-bit counting passes for 2-bit-packed 11-mer values (< 2^22;
    wider values fall back to a stable comparison sort), GIL released.
    Returns False when the native library is unavailable (caller keeps
    the numpy argsort path). All three arrays must be contiguous int64
    AND owned by the caller: they are permuted IN PLACE (the anib call
    site passes fresh boolean-index copies; do not pass arrays you need
    in their original order afterwards).
    """
    lib = _load_seedjoin()
    if lib is None:
        return False
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.seed_sort_rows(
        q_vals.ctypes.data_as(p64),
        q_within.ctypes.data_as(p64),
        q_frag.ctypes.data_as(p64),
        q_vals.size,
    )
    return True


def seed_join_diags_native(  # noqa: PLR0913
    table_vals: np.ndarray,
    table_pos: np.ndarray,
    q_vals: np.ndarray,
    q_within: np.ndarray,
    q_frag: np.ndarray,
    n_frags: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """(diags, per_fragment_counts) of the seed join, or None.

    ``diags`` holds every hit's (table_pos - q_within), grouped by
    fragment ascending and sorted ascending within each fragment's
    slice (slice f = diags[counts[:f].sum() : counts[:f+1].sum()]).
    ``table_vals`` must be ascending-sorted; ``q_vals``/``q_within``/
    ``q_frag`` must be parallel arrays sorted by ``q_vals`` (merge join).
    """
    lib = _load_seedjoin()
    if lib is None:
        return None
    p64 = ctypes.POINTER(ctypes.c_int64)
    tv = np.ascontiguousarray(table_vals, dtype=np.int64)
    tp = np.ascontiguousarray(table_pos, dtype=np.int64)
    qv = np.ascontiguousarray(q_vals, dtype=np.int64)
    qw = np.ascontiguousarray(q_within, dtype=np.int64)
    qf = np.ascontiguousarray(q_frag, dtype=np.int64)
    total = int(
        lib.seed_join_count_sorted(
            tv.ctypes.data_as(p64), tv.size, qv.ctypes.data_as(p64), qv.size
        )
    )
    out = np.empty(total, dtype=np.int64)
    counts = np.zeros(n_frags, dtype=np.int64)
    n = int(
        lib.seed_join_diags_sorted(
            tv.ctypes.data_as(p64),
            tp.ctypes.data_as(p64),
            tv.size,
            qv.ctypes.data_as(p64),
            qw.ctypes.data_as(p64),
            qf.ctypes.data_as(p64),
            qv.size,
            n_frags,
            counts.ctypes.data_as(p64),
            out.ctypes.data_as(p64),
            total,
        )
    )
    if n < 0:  # pragma: no cover - count/fill mismatch cannot happen
        return None
    return out[:n], counts




def _bind_suffix(lib) -> None:
    lib.kasai_lcp.restype = None
    lib.kasai_lcp.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.suffix_array_pd.restype = None
    lib.suffix_array_pd.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]


def _load_suffix():
    return _bound("suffix", _bind_suffix)


def _bind_sam(lib) -> None:
    if getattr(lib, "_sam_bound", False):
        return
    lib.sam_build.restype = ctypes.c_void_p
    lib.sam_build.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.sam_free.restype = None
    lib.sam_free.argtypes = [ctypes.c_void_p]
    lib.sam_states.restype = ctypes.c_int64
    lib.sam_states.argtypes = [ctypes.c_void_p]
    lib.sam_stream_ms.restype = None
    lib.sam_stream_ms.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sam_prepare_tour.restype = None
    lib.sam_prepare_tour.argtypes = [ctypes.c_void_p]
    lib.sam_stream_maxmatch.restype = ctypes.c_int64
    lib.sam_stream_maxmatch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib._sam_bound = True


class SamIndex:
    """Owning handle for a native suffix automaton over rev(text).

    Reusable, read-only after construction (concurrent streams are
    safe); frees the C++ side on garbage collection.
    """

    __slots__ = ("_handle", "_lib", "n", "_tour_lock", "_tour_ready")

    def __init__(self, lib, handle: int, n: int) -> None:
        self._lib = lib
        self._handle = handle
        self.n = n
        self._tour_lock = threading.Lock()
        self._tour_ready = False

    def ensure_tour(self) -> None:
        """Build the link-tree Euler tour once (maxmatch support)."""
        if self._tour_ready:
            return
        with self._tour_lock:
            if not self._tour_ready:
                self._lib.sam_prepare_tour(ctypes.c_void_p(self._handle))
                self._tour_ready = True

    def __del__(self) -> None:  # pragma: no cover - GC timing
        handle = getattr(self, "_handle", None)
        if handle:
            self._handle = None
            try:
                # argtypes=[c_void_p] accepts a plain int, so this needs
                # no ctypes globals (gone during interpreter shutdown).
                self._lib.sam_free(handle)
            except Exception:
                pass

    @property
    def states(self) -> int:
        return int(self._lib.sam_states(ctypes.c_void_p(self._handle)))


def sam_build_native(codes: np.ndarray) -> SamIndex | None:
    """Suffix automaton index of ``codes`` (built over the reversal)."""
    lib = _load_suffix()
    if lib is None:
        return None
    _bind_sam(lib)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    handle = lib.sam_build(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), codes.size
    )
    return SamIndex(lib, handle, codes.size)


def sam_stream_ms_native(
    index: SamIndex, qry: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-start matching statistics of qry vs the indexed text.

    Returns (ms_len int32[m], ref_start int64[m]); ref_start[j] >= 0
    only when the length-ms_len[j] match is unique in the indexed text.
    """
    qry = np.ascontiguousarray(qry, dtype=np.uint8)
    m = qry.size
    ms_len = np.empty(m, dtype=np.int32)
    ref_start = np.empty(m, dtype=np.int64)
    if m:
        index._lib.sam_stream_ms(
            ctypes.c_void_p(index._handle),
            qry.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m,
            ms_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ref_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    return ms_len, ref_start


def sam_stream_maxmatch_native(
    index: SamIndex, qry: np.ndarray, min_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All right-maximal matches >= min_len of qry vs the indexed text.

    Returns (ref_start, qry_start, length) int64 arrays; the caller
    applies the left-maximality filter.
    """
    index.ensure_tour()
    qry = np.ascontiguousarray(qry, dtype=np.uint8)
    m = qry.size
    cap = max(4096, 4 * m)
    while True:
        out_i = np.empty(cap, dtype=np.int64)
        out_j = np.empty(cap, dtype=np.int64)
        out_l = np.empty(cap, dtype=np.int64)
        count = index._lib.sam_stream_maxmatch(
            ctypes.c_void_p(index._handle),
            qry.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m,
            min_len,
            out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
        ) if m else 0
        if count <= cap:
            return (
                out_i[:count].copy(),
                out_j[:count].copy(),
                out_l[:count].copy(),
            )
        cap = int(count)


def kasai_lcp_native(text: np.ndarray, sa: np.ndarray):
    """Kasai LCP array via C++, or None if unavailable."""
    lib = _load_suffix()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.int64)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    lcp = np.zeros(text.size, dtype=np.int64)
    lib.kasai_lcp(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        text.size,
        lcp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return lcp




def _bind_band(lib) -> None:
    lib.band_affine.restype = None
    lib.band_affine.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]


def _load_band():
    return _bound("band", _bind_band)


def band_dp_native(  # noqa: PLR0913
    a: np.ndarray,
    b: np.ndarray,
    band: int,
    free_end: bool,
    match: int,
    mismatch: int,
    gap_open: int,
    gap_extend: int,
    stop_rows: int = 0,
):
    """Native affine banded DP -> (i, j, score, errors, nonid, gapcols),
    or None."""
    lib = _load_band()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    out = np.zeros(6, dtype=np.int64)
    lib.band_affine(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a.size,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b.size,
        band,
        1 if free_end else 0,
        match,
        mismatch,
        gap_open,
        gap_extend,
        stop_rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return tuple(int(v) for v in out)


def suffix_array_native(text: np.ndarray):
    """Suffix array via native prefix doubling, or None if unavailable."""
    lib = _load_suffix()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.int64)
    sa = np.zeros(text.size, dtype=np.int64)
    lib.suffix_array_pd(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        text.size,
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return sa




def _bind_chain(lib) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cluster_roots.restype = None
    lib.cluster_roots.argtypes = [
        i64p, i64p, i64p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_double,
        i64p,
    ]
    lib.chain_dp.restype = None
    lib.chain_dp.argtypes = [
        i64p, i64p, f64p, i64p, ctypes.c_int64, f64p, i64p,
    ]
    lib.anchor_chain_dp.restype = None
    lib.anchor_chain_dp.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, f64p, i64p,
    ]


def _load_chain():
    return _bound("chain", _bind_chain)


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def cluster_roots_native(
    r: np.ndarray,
    q: np.ndarray,
    length: np.ndarray,
    maxgap: int,
    diagdiff: int,
    diagfactor: float,
) -> np.ndarray | None:
    """mgaps union-find roots for (r, q)-sorted matches, or None."""
    lib = _load_chain()
    if lib is None:
        return None
    r = np.ascontiguousarray(r, dtype=np.int64)
    q = np.ascontiguousarray(q, dtype=np.int64)
    length = np.ascontiguousarray(length, dtype=np.int64)
    roots = np.empty(r.size, dtype=np.int64)
    lib.cluster_roots(
        _i64(r), _i64(q), _i64(length), r.size,
        maxgap, diagdiff, ctypes.c_double(diagfactor), _i64(roots),
    )
    return roots


def chain_dp_native(
    starts: np.ndarray,
    ends: np.ndarray,
    weights: np.ndarray,
    order: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | None:
    """delta-filter chain DP -> (best, prev), or None."""
    lib = _load_chain()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    n = starts.size
    best = np.empty(n, dtype=np.float64)
    prev = np.empty(n, dtype=np.int64)
    lib.chain_dp(
        _i64(starts), _i64(ends),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i64(order), n,
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i64(prev),
    )
    return best, prev


def anchor_chain_dp_native(
    r: np.ndarray, q: np.ndarray, length: np.ndarray
) -> tuple[np.ndarray, np.ndarray] | None:
    """Consistent anchor chain DP -> (best, prev), or None."""
    lib = _load_chain()
    if lib is None:
        return None
    r = np.ascontiguousarray(r, dtype=np.int64)
    q = np.ascontiguousarray(q, dtype=np.int64)
    length = np.ascontiguousarray(length, dtype=np.int64)
    n = r.size
    best = np.empty(n, dtype=np.float64)
    prev = np.empty(n, dtype=np.int64)
    lib.anchor_chain_dp(
        _i64(r), _i64(q), _i64(length), n,
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i64(prev),
    )
    return best, prev
