"""The port's streamed MUM seeding against the suffix-array oracle and the
JAX package: tests/test_mum_index.py, case for case.

The indexed path (native suffix automaton, ``ops/suffix.mum_matches_indexed``)
is ANIm's production seeding. Each case gives the same seeded input to
the port's indexed path, the port's combined-suffix-array oracle
(``maximal_matches``) and the JAX package's indexed path, and holds the
three match sets equal; the cache case holds the port's
``SeedIndexCache`` to the JAX package's eviction and reverse-complement
rules. The selection cases hold the native pass that turns the stream's
arrays into MUMs (``sam_select_mums_native``) to the numpy selection it
replaced, kept here as its oracle: the same arrays in the same order, and
the candidates it counts. The JAX file skips at import time without the suffix automaton;
these cases decide nothing at import: an automaton that does not build
fails them.
"""

from __future__ import annotations

import numpy as np
import pytest

import pyani_plus_tpu.ops.suffix as jax_suffix
from pyani_plus_tpu_torch import native
from pyani_plus_tpu_torch.genomes import complement_codes
from pyani_plus_tpu_torch.ops.suffix import (
    SEED_CACHE,
    SeedIndexCache,
    maximal_matches,
    mum_matches_indexed,
    seed_index_enabled,
)


@pytest.fixture(autouse=True)
def _automaton():
    assert seed_index_enabled(), "the port's suffix automaton did not build"


def _mum_sets(ref: np.ndarray, qry: np.ndarray, min_len: int):
    def matches(r, q, ln):
        return set(zip(r.tolist(), q.tolist(), ln.tolist()))

    old = matches(*maximal_matches(ref, qry, min_len, unique_ref=True, unique_qry=True))
    new = matches(*mum_matches_indexed(SEED_CACHE.sam_for(ref), ref, qry, min_len))
    jax = matches(*jax_suffix.mum_matches_indexed(jax_suffix.SEED_CACHE.sam_for(ref), ref, qry, min_len))
    assert new == jax
    return old, new


def test_fuzz_parity_vs_suffix_array() -> None:
    rng = np.random.default_rng(7)
    for _trial in range(40):
        n = int(rng.integers(60, 3000))
        ref = rng.integers(0, 4, n).astype(np.uint8)
        parts = []
        for _ in range(int(rng.integers(1, 6))):
            s = int(rng.integers(0, max(1, n - 50)))
            ln = int(rng.integers(30, min(700, n - s)))
            chunk = ref[s : s + ln].copy()
            mut = rng.random(ln) < rng.uniform(0, 0.1)
            chunk[mut] = (chunk[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            parts.append(chunk)
            if rng.random() < 0.4:  # a duplicated chunk: repeats in the query
                parts.append(chunk.copy())
            if rng.random() < 0.3:
                parts.append(rng.integers(0, 4, int(rng.integers(0, 60))).astype(np.uint8))
            if rng.random() < 0.3:  # ambiguous runs
                parts.append(np.full(int(rng.integers(1, 10)), 4, np.uint8))
        qry = np.concatenate(parts)
        if rng.random() < 0.5:
            ref = ref.copy()
            ref[rng.integers(0, n, int(rng.integers(1, 8)))] = 4
        old, new = _mum_sets(ref, qry, int(rng.integers(15, 25)))
        assert old == new


def test_boundary_and_identity_cases() -> None:
    rng = np.random.default_rng(11)
    seq = rng.integers(0, 4, 500).astype(np.uint8)
    old, new = _mum_sets(seq, seq.copy(), 20)
    assert old == new
    for piece in (seq[:100], seq[-100:], seq[200:350]):  # prefix, suffix, infix
        old, new = _mum_sets(seq, piece.copy(), 20)
        assert old == new
    assert _mum_sets(seq, np.empty(0, np.uint8), 20)[1] == set()
    assert _mum_sets(seq, seq[:10].copy(), 20)[1] == set()


def test_exact_query_duplication_is_dropped() -> None:
    """A block unique in the reference but twice in the query, with the
    same right context, is not unique in the query: no MUM spans it."""
    rng = np.random.default_rng(3)
    block = rng.integers(0, 4, 80).astype(np.uint8)
    other = rng.integers(0, 4, 200).astype(np.uint8)
    tail = other[:30]
    ref = np.concatenate([other[:100], block, tail, other[100:]])
    qry = np.concatenate([block, tail, other[30:67], block, tail])
    old, new = _mum_sets(ref, qry, 20)
    assert old == new
    assert not any(ln >= 110 for _r, _q, ln in new)


def test_cache_dedupes_and_evicts() -> None:
    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 4, 100).astype(np.uint8) for _ in range(3)]
    caches = (SeedIndexCache(sam_capacity=2, rep_capacity=2),
              jax_suffix.SeedIndexCache(sam_capacity=2, rep_capacity=2))  # fmt: skip
    for cache in caches:
        first = cache.sam_for(arrays[0])
        assert cache.sam_for(arrays[0]) is first  # a hit
        cache.sam_for(arrays[1])
        cache.sam_for(arrays[2])  # evicts arrays[0]
        assert ("sam", id(arrays[0])) not in cache._sam
        assert ("sam", id(arrays[2])) in cache._sam
        rc = cache.rc_for(arrays[0])
        assert rc is cache.rc_for(arrays[0])
        np.testing.assert_array_equal(rc, complement_codes(arrays[0])[::-1])
    assert list(caches[0]._sam) == list(caches[1]._sam)


def _numpy_selection(ms_len, ref_start, ref, qry, min_len):
    """``mum_matches_indexed``'s numpy selection before the native pass:
    a sort by ref start, each group's strict maximum length, then
    left-maximality -> ((i, j, length), candidates)."""
    j = np.nonzero((ms_len >= min_len) & (ref_start >= 0))[0]
    if not j.size:
        return (np.empty(0, np.int64),) * 3, 0
    i = ref_start[j]
    length = ms_len[j].astype(np.int64)
    order = np.lexsort((length, i))
    i_s, l_s = i[order], length[order]
    last_of_run = np.empty(order.size, dtype=bool)
    last_of_run[:-1] = i_s[1:] != i_s[:-1]
    last_of_run[-1] = True
    strict = np.ones(order.size, dtype=bool)
    strict[1:] = (i_s[1:] != i_s[:-1]) | (l_s[1:] > l_s[:-1])
    keep_sorted = order[last_of_run & strict]
    candidates = j.size
    i, j, length = i[keep_sorted], j[keep_sorted], length[keep_sorted]
    left_r = ref[np.maximum(i - 1, 0)]
    left_q = qry[np.maximum(j - 1, 0)]
    left_max = (j == 0) | (i == 0) | (left_r != left_q) | (left_r >= 4)
    keep = np.nonzero(left_max)[0]
    return (i[keep], j[keep].astype(np.int64), length[keep]), candidates


def _hand(n: int, m: int, rows, lefts=(), fill=None):
    """Stream arrays of m positions against a random ref of n bases with
    the candidates ``rows`` (j, i, length) and a ref start of -1
    elsewhere, at the length ``fill`` or one below min_len; each of
    ``lefts`` (j, i, ref base, query base) sets the left bases of one."""
    rng = np.random.default_rng(n + m)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    qry = rng.integers(0, 4, m).astype(np.uint8)
    ms_len = rng.integers(0, 12, m).astype(np.int32) if fill is None else np.full(m, fill, np.int32)
    ref_start = np.full(m, -1, np.int64)
    for j, i, length in rows:
        ms_len[j], ref_start[j] = length, i
        if i and j:  # left-maximal unless ``lefts`` says otherwise
            qry[j - 1] = (ref[i - 1] + 1) % 4
    for j, i, r, q in lefts:
        ref[i - 1], qry[j - 1] = r, q
    return ms_len, ref_start, ref, qry


def _random_groups():
    """Many candidates in few ref-start groups: ties, groups of several,
    ref starts of -1 and lengths about min_len."""
    rng = np.random.default_rng(31)
    n, m = 400, 3000
    ref = rng.integers(0, 5, n).astype(np.uint8)
    qry = rng.integers(0, 5, m).astype(np.uint8)
    ms_len = rng.integers(16, 25, m).astype(np.int32)
    ref_start = rng.integers(-1, n, m).astype(np.int64)
    return ms_len, ref_start, ref, qry


def _streamed(ref: np.ndarray, qry: np.ndarray):
    ms_len, ref_start, _lanes, _rewalked = native.sam_stream_ms_lanes_native(native.sam_build_native(ref), qry)
    return ms_len, ref_start, ref, qry


def _query_repeats():
    rng = np.random.default_rng(32)
    ref = rng.integers(0, 4, 30_000).astype(np.uint8)
    # ref[2000:6000] twice with one right context: a tie, and no MUM
    parts = [ref[2_000:6_000], ref[9_000:9_500], ref[2_000:6_000], ref[9_000:9_400], ref[20_000:20_700]]
    return _streamed(ref, np.concatenate(parts))


def _strains_pair():
    """A 200 kb genome and a strain of it at 0.5% substitutions: almost
    every query position a candidate, as in ANIm's strains cell."""
    rng = np.random.default_rng(33)
    ref = rng.integers(0, 4, 200_000).astype(np.uint8)
    qry = ref.copy()
    mut = rng.random(qry.size) < 0.005
    qry[mut] = (qry[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    return _streamed(ref, qry)


SELECTIONS = {
    "empty-query": lambda: _hand(100, 0, []),
    "no-candidates": lambda: _hand(100, 80, []),
    "all-below-min-len": lambda: _hand(100, 80, [(j, j, 19) for j in range(80)]),
    "ref-start-minus-one": lambda: _hand(100, 80, [(40, 7, 40)], fill=40),
    "tie-at-the-maximum": lambda: _hand(100, 60, [(5, 30, 25), (20, 30, 25), (8, 30, 22), (9, 60, 30), (30, 60, 30), (40, 60, 31)]),
    "group-of-three": lambda: _hand(100, 60, [(3, 40, 20), (15, 40, 27), (33, 40, 24), (50, 41, 21)]),
    "i-or-j-zero": lambda: _hand(100, 60, [(0, 50, 30), (12, 0, 25), (20, 70, 22)], lefts=[(20, 70, 2, 2)]),
    "ambiguous-left-bases": lambda: _hand(
        100, 60, [(5, 20, 30), (15, 40, 30), (25, 60, 30), (35, 80, 30)],
        lefts=[(5, 20, 4, 1), (15, 40, 3, 4), (25, 60, 4, 4), (35, 80, 1, 1)],
    ),
    "random-groups": _random_groups,
    "query-repeats": _query_repeats,
    "strains-pair-200kb": _strains_pair,
}
KEPT = {  # the MUMs some cases must keep, (i, j, length): none is vacuous
    "ref-start-minus-one": [(7, 40, 40)],
    "tie-at-the-maximum": [(60, 40, 31)],
    "group-of-three": [(40, 15, 27), (41, 50, 21)],
    "i-or-j-zero": [(0, 12, 25), (50, 0, 30)],
    "ambiguous-left-bases": [(20, 5, 30), (40, 15, 30), (60, 25, 30)],
}


@pytest.mark.parametrize("case", list(SELECTIONS))
def test_native_selection_equals_the_numpy_selection(case: str) -> None:
    ms_len, ref_start, ref, qry = SELECTIONS[case]()
    (want_i, want_j, want_len), want_candidates = _numpy_selection(ms_len, ref_start, ref, qry, 20)
    i, j, length, candidates = native.sam_select_mums_native(ms_len.copy(), ref_start.copy(), ref, qry, 20)
    for got, want in ((i, want_i), (j, want_j), (length, want_len)):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert candidates == want_candidates
    if case in KEPT:
        assert list(zip(i.tolist(), j.tolist(), length.tolist())) == KEPT[case]
    if case in ("query-repeats", "strains-pair-200kb", "random-groups"):
        assert i.size and candidates > 5 * i.size
    if case == "query-repeats":
        assert 2_000 not in i.tolist() and 9_000 in i.tolist()
