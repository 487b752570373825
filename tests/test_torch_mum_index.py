"""The port's streamed MUM seeding against the suffix-array oracle and the
JAX package: tests/test_mum_index.py, case for case.

The indexed path (native suffix automaton, ``ops/suffix.mum_matches_indexed``)
is ANIm's production seeding. Each case gives the same seeded input to
the port's indexed path, the port's combined-suffix-array oracle
(``maximal_matches``) and the JAX package's indexed path, and holds the
three match sets equal; the cache case holds the port's
``SeedIndexCache`` to the JAX package's eviction and reverse-complement
rules. The JAX file skips at import time without the suffix automaton;
these cases decide nothing at import: an automaton that does not build
fails them.
"""

from __future__ import annotations

import numpy as np
import pytest

import pyani_plus_tpu.ops.suffix as jax_suffix
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
