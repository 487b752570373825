"""The port's streamed maxmatch seeding against the suffix-array oracle and
the JAX package: tests/test_maxmatch_index.py, case for case.

dnadiff seeds with every maximal match (nucmer --maxmatch): the
suffix-automaton link-tree walk ``ops/suffix.max_matches_indexed``. Each
case gives the same seeded input, with repeats inside the reference and
duplications in the query, to the port's indexed path, the port's
suffix-array oracle and the JAX package's indexed path, and holds the
three match sets equal. Nothing is decided at import: an automaton that
does not build fails the cases.
"""

from __future__ import annotations

import numpy as np
import pytest

import pyani_plus_tpu.ops.suffix as jax_suffix
from pyani_plus_tpu_torch.ops.suffix import (
    SEED_CACHE,
    max_matches_indexed,
    maximal_matches,
    seed_index_enabled,
)


@pytest.fixture(autouse=True)
def _automaton():
    assert seed_index_enabled(), "the port's suffix automaton did not build"


def _sets(ref: np.ndarray, qry: np.ndarray, min_len: int):
    def matches(r, q, ln):
        return set(zip(r.tolist(), q.tolist(), ln.tolist()))

    old = matches(*maximal_matches(ref, qry, min_len, unique_ref=False, unique_qry=False))
    new = matches(*max_matches_indexed(SEED_CACHE.sam_for(ref), ref, qry, min_len))
    jax = matches(*jax_suffix.max_matches_indexed(jax_suffix.SEED_CACHE.sam_for(ref), ref, qry, min_len))
    assert new == jax
    return old, new


def test_fuzz_parity_vs_suffix_array() -> None:
    rng = np.random.default_rng(13)
    for _trial in range(30):
        n = int(rng.integers(60, 2000))
        ref_parts = [rng.integers(0, 4, n).astype(np.uint8)]
        if rng.random() < 0.6:  # a repeat inside the reference: multiplicity
            ref_parts.append(ref_parts[0][: int(rng.integers(25, 200))].copy())
        ref = np.concatenate(ref_parts)
        parts = []
        for _ in range(int(rng.integers(1, 5))):
            s = int(rng.integers(0, max(1, n - 50)))
            ln = int(rng.integers(30, min(600, n - s)))
            chunk = ref[s : s + ln].copy()
            mut = rng.random(ln) < rng.uniform(0, 0.1)
            chunk[mut] = (chunk[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            parts.append(chunk)
            if rng.random() < 0.4:
                parts.append(chunk.copy())
            if rng.random() < 0.3:
                parts.append(np.full(int(rng.integers(1, 10)), 4, np.uint8))
        qry = np.concatenate(parts)
        if rng.random() < 0.5:
            ref = ref.copy()
            ref[rng.integers(0, ref.size, int(rng.integers(1, 8)))] = 4
        old, new = _sets(ref, qry, int(rng.integers(15, 25)))
        assert old == new


def test_multiplicity_exact_lengths() -> None:
    """Three reference copies of a block in distinct contexts: the query's
    occurrence pairs with each copy at the exact pairwise length."""
    rng = np.random.default_rng(23)
    block = rng.integers(0, 4, 60).astype(np.uint8)
    spacers = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(4)]
    ref = np.concatenate([spacers[0], block, spacers[1], block, spacers[2], block, spacers[3]])
    qry = np.concatenate([block, rng.integers(0, 4, 30).astype(np.uint8)])
    old, new = _sets(ref, qry, 20)
    assert old == new
    assert len(new) >= 3


def test_empty_and_short_inputs() -> None:
    rng = np.random.default_rng(29)
    seq = rng.integers(0, 4, 300).astype(np.uint8)
    assert _sets(seq, np.empty(0, np.uint8), 20)[1] == set()
    assert _sets(seq, seq[:10].copy(), 20)[1] == set()
    old, new = _sets(seq, seq.copy(), 20)
    assert old == new
