"""Native (C++) host-side kernels, loaded via ctypes with lazy build.

The card owns the batched scoring math; these cover the host stages of
the methods: sketch hashing (``sketch.cpp``), suffix automaton seeding
(``suffix.cpp``), clustering and the delta-filter chain DP
(``chain.cpp``), the banded affine DP with ANIm's consistent anchor
chain and its per-cluster chain and gap fills (``band.cpp``), the local
alignment score and stats DPs (``align.cpp``), the seed join
(``seedjoin.cpp``), minimap2's sketch, chain and backtrack (``mm2.cpp``,
ANIminimap2) and fastANI's winnowing and fragment mapping
(``fastani.cpp``). The wrappers of the last two are copied from the JAX
package's ``native/__init__.py`` unchanged; only their loaders differ.
Each library is built with g++ on first use through ``ops/_build.py``
(source hash in the file name, written under a private name and
renamed, one lock held across build and load), so concurrent threads
and processes all get the finished library. Absence of a compiler
degrades gracefully to the numpy implementations: every wrapper then
returns ``None`` (or ``False``).
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


def _bind_sam_lanes(lib) -> None:
    if getattr(lib, "_sam_lanes_bound", False):
        return
    _bind_sam(lib)
    lib.sam_ms_lanes.restype = ctypes.c_int32
    lib.sam_ms_lanes.argtypes = [ctypes.c_int64]
    lib.sam_stream_ms_lanes.restype = ctypes.c_int64
    lib.sam_stream_ms_lanes.argtypes = lib.sam_stream_ms.argtypes
    lib.sam_select_mums.restype = ctypes.c_int64
    lib.sam_select_mums.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib._sam_lanes_bound = True


def sam_stream_ms_lanes_native(
    index: SamIndex, qry: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """``sam_stream_ms_native``'s arrays, position for position, streamed
    in interleaved lanes -> (ms_len, ref_start, lanes, rewalked).

    ``lanes`` follows from the query's length alone (1: the serial
    stream ran); ``rewalked`` counts the positions the boundary fix-up
    streamed again.
    """
    _bind_sam_lanes(index._lib)
    qry = np.ascontiguousarray(qry, dtype=np.uint8)
    m = qry.size
    ms_len = np.empty(m, dtype=np.int32)
    ref_start = np.empty(m, dtype=np.int64)
    rewalked = index._lib.sam_stream_ms_lanes(
        ctypes.c_void_p(index._handle),
        qry.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        m,
        ms_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ref_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return ms_len, ref_start, int(index._lib.sam_ms_lanes(m)), int(rewalked)


def sam_select_mums_native(
    ms_len: np.ndarray,
    ref_start: np.ndarray,
    ref: np.ndarray,
    qry: np.ndarray,
    min_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int] | None:
    """MUMs from ``sam_stream_ms_lanes_native``'s arrays in one native
    linear pass -> (ref_start, qry_start, length, candidates), or None
    without the library.

    The triples are int64, in ascending ref start, and as many as the
    MUMs; ``candidates`` counts the query starts of length >= min_len
    with a unique ref start that the selection took in. The call writes
    its result over the fronts of ``ms_len`` (int32) and ``ref_start``
    (int64) where they come in with those types, contiguous: the stream's
    arrays are spent.
    """
    if ms_len.shape != ref_start.shape or ms_len.ndim != 1:
        raise ValueError(f"stream arrays of shapes {ms_len.shape} and {ref_start.shape}")
    if ms_len.size > qry.size:
        raise ValueError(f"{ms_len.size} stream positions for a query of {qry.size}")
    lib = _load_suffix()
    if lib is None:
        return None
    _bind_sam_lanes(lib)
    ms_len = np.ascontiguousarray(ms_len, dtype=np.int32)
    ref_start = np.ascontiguousarray(ref_start, dtype=np.int64)
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    qry = np.ascontiguousarray(qry, dtype=np.uint8)
    candidates = ctypes.c_int64(0)
    k = lib.sam_select_mums(
        ms_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ref_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ms_len.size,
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ref.size,
        qry.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        min_len,
        ctypes.byref(candidates),
    )
    if k < 0:
        raise MemoryError(f"no table over a reference of {ref.size} bases")
    packed = ref_start[:k]
    return packed & 0xFFFFFFFF, packed >> 32, ms_len[:k].astype(np.int64), candidates.value


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
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.anchor_chain_dp.restype = None
    lib.anchor_chain_dp.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, f64p, i64p,
    ]
    lib.chain_and_fill.restype = ctypes.c_int64
    lib.chain_and_fill.argtypes = [
        i64p, i64p, i64p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        i64p,
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


def _bind_mm2(lib) -> None:
    lib.mm2_sketch.restype = ctypes.c_int64
    lib.mm2_sketch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mm2_chain_rmq2_f.restype = None
    lib.mm2_chain_rmq2_f.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mm2_chain_rmq2.restype = None
    lib.mm2_chain_rmq2.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mm2_backtrack.restype = ctypes.c_int64
    lib.mm2_backtrack.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]


def _load_mm2():
    return _bound("mm2", _bind_mm2)


def mm2_sketch_native(codes: np.ndarray, k: int, w: int):
    """minimap2 mm_sketch -> (hashes, end_positions, strands), or None."""
    lib = _load_mm2()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.size
    out_h = np.empty(n, dtype=np.uint64)
    out_p = np.empty(n, dtype=np.int32)
    out_s = np.empty(n, dtype=np.uint8)
    count = lib.mm2_sketch(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        k,
        w,
        out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out_h[:count], out_p[:count], out_s[:count]


def mm2_chain_rmq2_native(  # noqa: PLR0913
    ax: np.ndarray,
    ay: np.ndarray,
    q_span: int,
    max_dist: int,
    max_dist_inner: int,
    bw: int,
    chn_pen_gap: float,
    max_skip: int = 25,
    cap_rmq_size: int = 100000,
    pri_mode: int = 0,
    flags: int = 0,
):
    """mg_chain_rmq heuristic chain scores -> (f, p), or None."""
    lib = _load_mm2()
    if lib is None:
        return None
    ax = np.ascontiguousarray(ax, dtype=np.int64)
    ay = np.ascontiguousarray(ay, dtype=np.int32)
    n = ax.size
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    lib.mm2_chain_rmq2_f(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ay.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        q_span,
        max_dist,
        max_dist_inner,
        bw,
        max_skip,
        cap_rmq_size,
        chn_pen_gap,
        pri_mode,
        flags,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return f, p


def mm2_backtrack_native(
    f: np.ndarray,
    p: np.ndarray,
    max_drop: int,
    min_sc: int,
    min_cnt: int,
):
    """mg_chain_backtrack -> [(score, anchor_idx_ascending)], or None."""
    lib = _load_mm2()
    if lib is None:
        return None
    f = np.ascontiguousarray(f, dtype=np.int32)
    p = np.ascontiguousarray(p, dtype=np.int64)
    n = f.size
    v = np.empty(n, dtype=np.int64)
    off = np.empty(n + 1, dtype=np.int64)
    sc = np.empty(max(n, 1), dtype=np.int32)
    n_chains = lib.mm2_backtrack(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        max_drop,
        min_sc,
        min_cnt,
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return [
        (int(sc[c]), v[off[c] : off[c + 1]].copy())
        for c in range(n_chains)
    ]


def _bind_fastani(lib) -> None:
    lib.fastani_eval_region.restype = None
    lib.fastani_eval_region.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastani_eval_region_all.restype = None
    lib.fastani_eval_region_all.argtypes = (
        lib.fastani_eval_region.argtypes[:10]
        + [ctypes.POINTER(ctypes.c_int64)]
    )
    lib.fastani_winnow.restype = ctypes.c_int64
    lib.fastani_winnow.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]


def _load_fastani():
    return _bound("fastani", _bind_fastani)


def fastani_eval_region_native(  # noqa: PLR0913
    query_hashes_sorted: np.ndarray,
    entry_hash: np.ndarray,
    entry_first: np.ndarray,
    entry_last: np.ndarray,
    event_t: np.ndarray,
    w_steps: int,
    s: int,
    region_b: int | None = None,
):
    """Fenwick-sweep region eval -> (shared, first_t, plateau_end), or None.

    ``region_b`` is the last anchor of the region for the plateau-end
    extension (defaults to the last event).
    """
    lib = _load_fastani()
    if lib is None:
        return None
    qh = np.ascontiguousarray(query_hashes_sorted, dtype=np.uint64)
    eh = np.ascontiguousarray(entry_hash, dtype=np.uint64)
    ef = np.ascontiguousarray(entry_first, dtype=np.int64)
    el = np.ascontiguousarray(entry_last, dtype=np.int64)
    ev = np.ascontiguousarray(event_t, dtype=np.int64)
    if region_b is None:
        region_b = int(ev[-1]) if ev.size else 0
    out = np.zeros(3, dtype=np.int64)
    lib.fastani_eval_region(
        qh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        qh.size,
        eh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ef.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        el.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        eh.size,
        ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ev.size,
        w_steps,
        s,
        region_b,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return int(out[0]), int(out[1]), int(out[2])


def fastani_eval_region_all_native(  # noqa: PLR0913
    query_hashes_sorted: np.ndarray,
    entry_hash: np.ndarray,
    entry_first: np.ndarray,
    entry_last: np.ndarray,
    event_t: np.ndarray,
    w_steps: int,
    s: int,
) -> np.ndarray | None:
    """Shared count at EVERY event window (L2 diagnostics), or None."""
    lib = _load_fastani()
    if lib is None:
        return None
    qh = np.ascontiguousarray(query_hashes_sorted, dtype=np.uint64)
    eh = np.ascontiguousarray(entry_hash, dtype=np.uint64)
    ef = np.ascontiguousarray(entry_first, dtype=np.int64)
    el = np.ascontiguousarray(entry_last, dtype=np.int64)
    ev = np.ascontiguousarray(event_t, dtype=np.int64)
    out = np.zeros(max(1, ev.size), dtype=np.int64)
    lib.fastani_eval_region_all(
        qh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        qh.size,
        eh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ef.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        el.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        eh.size,
        ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ev.size,
        w_steps,
        s,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[: ev.size]


def fastani_winnow_native(seq_bytes, k: int, w: int, seed: int = 42):
    """Winnowed minimizer pick runs -> 5 arrays, or None if unavailable.

    Returns (hashes, positions, strands, first_steps, last_steps) with the
    same contract as ops.minimizers.window_minimizers.
    """
    lib = _load_fastani()
    if lib is None:
        return None
    seq = (
        np.frombuffer(seq_bytes, dtype=np.uint8)
        if isinstance(seq_bytes, (bytes, bytearray))
        else np.ascontiguousarray(seq_bytes, dtype=np.uint8)
    )
    n = seq.size
    n_win = n - k + 1
    if n_win < max(w, 1):
        return (
            np.empty(0, np.uint64),
            np.empty(0, np.int64),
            np.empty(0, np.int8),
            np.empty(0, np.int64),
            np.empty(0, np.int64),
        )
    # Expected run count ~ 2*n/(w+1); retry with the exact count if short.
    cap = max(1024, int(n_win * 2 / (w + 1)) + int(n_win * 0.1))
    while True:
        out_h = np.empty(cap, dtype=np.uint64)
        out_p = np.empty(cap, dtype=np.int64)
        out_s = np.empty(cap, dtype=np.int8)
        out_f = np.empty(cap, dtype=np.int64)
        out_l = np.empty(cap, dtype=np.int64)
        count = lib.fastani_winnow(
            seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            k,
            w,
            seed,
            out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
        )
        if count <= cap:
            return (
                out_h[:count].copy(),
                out_p[:count].copy(),
                out_s[:count].copy(),
                out_f[:count].copy(),
                out_l[:count].copy(),
            )
        cap = int(count)


def _bind_map_fragment(lib):
    if getattr(lib, "_map_fragment_bound", False):
        return
    lib.fastani_map_fragment.restype = None
    lib.fastani_map_fragment.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib._map_fragment_bound = True


def fastani_map_fragment_native(  # noqa: PLR0913
    query_hashes_sorted: np.ndarray,
    ref_hash: np.ndarray,
    ref_first: np.ndarray,
    ref_last: np.ndarray,
    ref_seq: np.ndarray,
    ref_hash_sorted: np.ndarray,
    ref_sorted_entry: np.ndarray,
    seq_lo: np.ndarray,
    seq_hi: np.ndarray,
    seq_ids: np.ndarray,
    w_steps: int,
    s: int,
    frag_span: int,
    min_anchor: int,
):
    """Full native fragment L2 mapping -> (shared, plateau_end, seq_id),
    or None when the native library is unavailable."""
    lib = _load_fastani()
    if lib is None:
        return None
    _bind_map_fragment(lib)
    out = np.zeros(3, dtype=np.int64)
    lib.fastani_map_fragment(
        query_hashes_sorted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        query_hashes_sorted.size,
        ref_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ref_first.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ref_last.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ref_seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ref_hash_sorted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ref_sorted_entry.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ref_hash.size,
        seq_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seq_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seq_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        seq_ids.size,
        w_steps,
        s,
        frag_span,
        min_anchor,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return int(out[0]), int(out[1]), int(out[2])


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
    lib = _load_band()
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


def chain_and_fill_native(  # noqa: PLR0913
    ref: np.ndarray,
    qry: np.ndarray,
    r: np.ndarray,
    q: np.ndarray,
    length: np.ndarray,
    match: int,
    mismatch: int,
    gap_open: int,
    gap_extend: int,
):
    """One cluster's consistent chain and gap fills in one call ->
    (fill, gaps), or None if unavailable.

    ``fill`` is ANIm's (errors, nonid, gapcols, rs, qs, prev_re, prev_qe),
    or None for a cluster without anchors; ``gaps`` counts the gaps filled.
    The library call holds no interpreter lock, so pair threads fill their
    clusters at the same time.
    """
    lib = _load_band()
    if lib is None:
        return None
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    qry = np.ascontiguousarray(qry, dtype=np.uint8)
    r = np.ascontiguousarray(r, dtype=np.int64)
    q = np.ascontiguousarray(q, dtype=np.int64)
    length = np.ascontiguousarray(length, dtype=np.int64)
    out = np.zeros(7, dtype=np.int64)
    gaps = lib.chain_and_fill(
        _i64(r), _i64(q), _i64(length), r.size,
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ref.size,
        qry.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), qry.size,
        match, mismatch, gap_open, gap_extend, _i64(out),
    )
    if gaps < 0:
        return None, 0
    return tuple(int(v) for v in out), gaps
