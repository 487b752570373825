"""The port's merge-join, chain-DP and stats-DP native kernels against
their numpy fallbacks and the JAX package: tests/test_native_parity_extra.py,
case for case.

Each case runs the port's function with its native kernel, then with the
port's native wrapper patched to ``None`` (the numpy fallback, as the JAX
case patches its own), and the JAX package's function on the same input,
and holds all three equal, exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import pyani_plus_tpu.methods.anib as jax_anib
import pyani_plus_tpu.ops.chaining as jax_chaining
import pyani_plus_tpu.ops.dp as jax_dp
from pyani_plus_tpu.ops.seeds import SeedIndex as JaxSeedIndex
from pyani_plus_tpu_torch import native
from pyani_plus_tpu_torch.methods import anib
from pyani_plus_tpu_torch.ops import dp
from pyani_plus_tpu_torch.ops.chaining import Alignment, many_to_many, one_to_one
from pyani_plus_tpu_torch.ops.seeds import SeedIndex


def _random_alignments(rng, n):
    out = []
    for _ in range(n):
        rs, qs, ln = int(rng.integers(0, 5000)), int(rng.integers(0, 5000)), int(rng.integers(50, 800))
        out.append(dict(ref_start=rs, ref_end=rs + ln, qry_start=qs,
                        qry_end=qs + ln + int(rng.integers(-10, 10)),
                        errors=int(rng.integers(0, ln // 4))))  # fmt: skip
    return out


def _kept(filt, blocks) -> list[int]:
    kept = {id(a) for a in filt(blocks)}
    return [i for i, block in enumerate(blocks) if id(block) in kept]


def test_chain_dp_native_matches_numpy_fallback(monkeypatch) -> None:
    rng = np.random.default_rng(17)
    cases = [_random_alignments(rng, int(rng.integers(1, 60))) for _ in range(20)]

    def run(package) -> list[tuple]:
        filters = (one_to_one, many_to_many) if package is None else (
            package.one_to_one, package.many_to_many)
        make = Alignment if package is None else package.Alignment
        out = []
        for case in cases:
            blocks = [make(**fields) for fields in case]
            out.append(tuple(_kept(f, blocks) for f in filters))
        return out

    got_native = run(None)
    jax = run(jax_chaining)
    monkeypatch.setattr(native, "chain_dp_native", lambda *a, **k: None)
    assert got_native == run(None) == jax


def test_seed_join_native_matches_numpy_fallback(monkeypatch) -> None:
    """The per-fragment diagonal sets of ``_record_strand_diags`` are the
    same with and without the native merge join, and the JAX package's."""
    rng = np.random.default_rng(5)
    subject = rng.integers(0, 4, 12000).astype(np.uint8)
    query = np.concatenate([
        subject[2000:5000],
        rng.integers(0, 4, 2000).astype(np.uint8),
        subject[7000:9000][::-1],  # a reversed chunk: minus-strand hits
    ])  # fmt: skip
    plus_a, minus_a = anib._record_strand_diags(query, SeedIndex(subject), 1020)
    plus_j, minus_j = jax_anib._record_strand_diags(query, JaxSeedIndex(subject), 1020)
    monkeypatch.setattr(native, "seed_join_diags_native", lambda *a, **k: None)
    plus_b, minus_b = anib._record_strand_diags(query, SeedIndex(subject), 1020)
    for a, b, j in ((plus_a, plus_b, plus_j), (minus_a, minus_b, minus_j)):
        assert set(a) == set(b) == set(j)
        for frag in a:
            assert np.array_equal(np.sort(a[frag]), np.sort(b[frag])), frag
            assert np.array_equal(a[frag], j[frag]), frag
    assert plus_a and minus_a  # the shared stretches really hit


def test_local_align_stats_native_matches_numpy() -> None:
    """ops/dp.local_align_stats, native against the numpy oracle, with N
    runs on both sides (the N-column identity accounting) and indels."""
    rng = np.random.default_rng(29)
    for _ in range(30):
        m = int(rng.integers(20, 250))
        q = rng.integers(0, 4, m).astype(np.uint8)
        s = q.copy()
        mut = rng.random(m) < 0.1
        s[mut] = (s[mut] + 1) % 4
        if rng.random() < 0.4:
            start = int(rng.integers(0, max(1, m - 12)))
            ln = int(rng.integers(1, 12))
            q[start : start + ln] = 4
            s[start : start + ln] = 4
        if rng.random() < 0.5:
            cut = int(rng.integers(1, m - 1))
            s = np.concatenate([s[:cut], rng.integers(0, 4, 3, dtype=np.uint8), s[cut:]])
        got = dp.local_align_stats(q, s)
        oracle = dp.local_align_stats(q, s, force_numpy=True)
        jax = jax_dp.local_align_stats(q, s)
        assert (got is None) == (oracle is None) == (jax is None)
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(oracle) == dataclasses.astuple(jax)
