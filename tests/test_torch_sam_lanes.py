"""ANIm's matching-statistics stream in interleaved lanes against the
serial stream, position for position.

``native/suffix.cpp``'s ``sam_stream_ms_lanes`` splits the query into
contiguous lanes (one a 16,384 bases, at most 16), streams them in
lockstep and mends each lane's right end from the lane to its right. Each
case gives one input to it, to the port's serial ``sam_stream_ms`` and to
the JAX package's, and holds ``ms_len`` and ``ref_start`` equal at every
position; it also holds the MUMs of ``mum_matches_indexed``, which streams
in lanes, to the suffix-array oracle ``maximal_matches``, and its counters
to the lanes, the positions streamed again and the candidates. The cases: a
fuzz over seeds, a self-pair (every boundary inside one match), one MUM
across several lanes, N runs across lane boundaries and an N at a lane's
either end, queries of one lane or less (0, 1 and 32,767 bases: the
serial loop), and a minus strand that matches nothing beyond chance.
"""

from __future__ import annotations

import numpy as np
import pytest

import pyani_plus_tpu.native as jax_native
from pyani_plus_tpu_torch import native
from pyani_plus_tpu_torch.genomes import complement_codes
from pyani_plus_tpu_torch.ops.suffix import maximal_matches, mum_matches_indexed, seed_index_enabled
from pyani_plus_tpu_torch.utils import spans

LANE = 1 << 14  # MS_LANE_MIN


def _mutate(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    out = codes.copy()
    mut = rng.random(out.size) < rate
    out[mut] = (out[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    return out


def _bounds(m: int, lanes: int) -> list[int]:
    return [m * k // lanes for k in range(lanes + 1)]


def _fuzz(seed: int):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, int(rng.integers(40_000, 120_000))).astype(np.uint8)
    parts = []
    while sum(p.size for p in parts) < int(rng.integers(2, 12)) * LANE:
        s = int(rng.integers(0, ref.size - 2_000))
        chunk = _mutate(rng, ref[s : s + int(rng.integers(200, 20_000))], rng.uniform(0, 0.02))
        parts.append(chunk)
        if rng.random() < 0.3:  # a repeat in the query
            parts.append(chunk.copy())
        if rng.random() < 0.3:
            parts.append(rng.integers(0, 4, int(rng.integers(0, 3_000))).astype(np.uint8))
        if rng.random() < 0.3:
            parts.append(np.full(int(rng.integers(1, 40)), 4, np.uint8))
    if rng.random() < 0.5:
        ref[rng.integers(0, ref.size, 20)] = 4
    return ref, np.concatenate(parts)


def _self_pair():
    ref = np.random.default_rng(21).integers(0, 4, 5 * LANE + 77).astype(np.uint8)
    return ref, ref.copy()


def _one_mum_across_lanes():
    rng = np.random.default_rng(22)
    ref = rng.integers(0, 4, 90_000).astype(np.uint8)
    flank = rng.integers(0, 4, 2 * LANE).astype(np.uint8)
    return ref, np.concatenate([flank, ref[5_000:75_000], flank[::-1].copy()])


def _n_on_boundaries():
    rng = np.random.default_rng(23)
    ref = rng.integers(0, 4, 100_000).astype(np.uint8)
    qry = _mutate(rng, ref, 0.003)
    m = qry.size
    cut = _bounds(m, native.sam_stream_ms_lanes_native(native.sam_build_native(ref), qry)[2])
    qry[cut[1] - 3 : cut[1] + 4] = 4  # a run across a boundary
    qry[cut[2] - 1] = 4  # a lane's last base
    qry[cut[3]] = 4  # a lane's first base
    qry[cut[4] - 1 : cut[4] + 1] = 4  # both sides of a boundary
    qry[m - 1] = 4
    return ref, qry


def _short(length: int):
    def make():
        rng = np.random.default_rng(24)
        ref = rng.integers(0, 4, 50_000).astype(np.uint8)
        return ref, _mutate(rng, ref[1_000 : 1_000 + length], 0.003)

    return make


def _minus_strand():
    rng = np.random.default_rng(25)
    ref = rng.integers(0, 4, 150_000).astype(np.uint8)
    return ref, complement_codes(_mutate(rng, ref, 0.003))[::-1].copy()


CASES = {
    **{f"fuzz-{seed}": (lambda seed=seed: _fuzz(seed)) for seed in range(4)},
    "self-pair": _self_pair,
    "one-mum-across-lanes": _one_mum_across_lanes,
    "n-on-boundaries": _n_on_boundaries,
    "length-0": _short(0),
    "length-1": _short(1),
    "one-lane": _short(2 * LANE - 1),
    "minus-strand": _minus_strand,
}


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_equal_the_serial_stream(case: str) -> None:
    assert seed_index_enabled(), "the port's suffix automaton did not build"
    ref, qry = CASES[case]()
    m = qry.size
    index = native.sam_build_native(ref)
    ms_len, ref_start, lanes, rewalked = native.sam_stream_ms_lanes_native(index, qry)
    assert lanes == max(1, min(16, m // LANE))
    for serial in (native.sam_stream_ms_native(index, qry),
                   jax_native.sam_stream_ms_native(jax_native.sam_build_native(ref), qry)):  # fmt: skip
        np.testing.assert_array_equal(ms_len, serial[0])
        np.testing.assert_array_equal(ref_start, serial[1])
    if lanes == 1:
        assert rewalked == 0
    if case == "self-pair":  # every lane but the last is streamed again
        assert rewalked == _bounds(m, lanes)[-2]
    if case == "one-mum-across-lanes":
        assert lanes >= 5 and ms_len.max() >= 70_000
    if case == "minus-strand":
        assert lanes > 1 and ms_len.max() < 30 and rewalked < 40 * (lanes - 1)

    before = spans.counters()
    with spans.recording():
        got = mum_matches_indexed(index, ref, qry, 20)
    after = spans.counters()
    names = ("anim.seed_lanes", "anim.seed_rewalked", "anim.seed_candidates")
    grown = {name: after.get(name, 0) - before.get(name, 0) for name in names}
    candidates = int(np.count_nonzero((ms_len >= 20) & (ref_start >= 0)))
    assert grown == {"anim.seed_lanes": lanes if lanes > 1 else 0, "anim.seed_rewalked": rewalked,
                     "anim.seed_candidates": candidates}  # fmt: skip
    expected = maximal_matches(ref, qry, 20, unique_ref=True, unique_qry=True)
    assert set(zip(*(a.tolist() for a in got))) == set(zip(*(a.tolist() for a in expected)))
