"""The port's native host kernels against their numpy oracles and the JAX
package's: tests/test_native.py, case for case.

The port builds its own C++ libraries (``ops/_build.load_host_library``)
from its own ``native/*.cpp``. Each case gives the same seeded input to
the port's native wrapper, to the port's numpy oracle (the native
function patched away where the JAX case patches it), and to the JAX
package's function, and holds all equal, exact. ``_band_dp`` is the
port's ``ops/extend_host._band_dp``.

Where the JAX file skips at import time without a compiler (a
module-level ``skipif`` on ``have_native()``), these cases decide nothing
at import: a library that does not build fails the case.

One case more, ``test_band_trials_through_the_extension_dispatch``: the
band DP fuzz inputs as free-end extension tasks at the port's band of 60
through the port's CPU dispatch, against the native kernel.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pyani_plus_tpu.native as jax_native
from pyani_plus_tpu.ops import extend as jax_extend
from pyani_plus_tpu.ops import suffix as jax_suffix
from pyani_plus_tpu.ops.kmers import canonical_kmer_hashes as jax_canonical_kmer_hashes
from pyani_plus_tpu_torch import native
from pyani_plus_tpu_torch.ops import extend as ext
from pyani_plus_tpu_torch.ops.extend_host import _band_dp
from pyani_plus_tpu_torch.ops.kmers import canonical_kmer_hashes
from pyani_plus_tpu_torch.ops.minhash import max_hash_for_scaled
from pyani_plus_tpu_torch.ops.suffix import lcp_array, suffix_array
from pyani_plus_tpu_torch.synthetic import band_dp_trials


@pytest.fixture
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _sketch(codes: np.ndarray, k: int, max_hash: int) -> np.ndarray:
    got = native.sketch_codes_native(codes, k, max_hash)
    assert got is not None, "the port's sketch library did not build"
    assert np.array_equal(got, jax_native.sketch_codes_native(codes, k, max_hash))
    return got


def test_unfiltered_parity() -> None:
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 50_000).astype(np.uint8)
    codes[rng.random(codes.size) < 0.01] = 4  # sprinkle Ns
    want = canonical_kmer_hashes(codes, 31)
    assert np.array_equal(want, jax_canonical_kmer_hashes(codes, 31))
    assert np.array_equal(_sketch(codes, 31, 2**64 - 1), want)


def test_scaled_filter_parity() -> None:
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, 200_000).astype(np.uint8)
    max_hash = max_hash_for_scaled(1000)
    want = canonical_kmer_hashes(codes, 31)
    assert np.array_equal(_sketch(codes, 31, max_hash), want[want <= np.uint64(max_hash)])


def test_short_and_empty() -> None:
    assert _sketch(np.zeros(10, np.uint8), 31, 2**64 - 1).size == 0
    assert _sketch(np.zeros(0, np.uint8), 31, 2**64 - 1).size == 0


def test_k16_parity() -> None:
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, 30_000).astype(np.uint8)
    want = canonical_kmer_hashes(codes, 16)
    assert np.array_equal(want, jax_canonical_kmer_hashes(codes, 16))
    assert np.array_equal(_sketch(codes, 16, 2**64 - 1), want)


def _py_suffix_array(text: np.ndarray) -> np.ndarray:
    return np.asarray(sorted(range(text.size), key=lambda i: tuple(text[i:].tolist())), dtype=np.int64)


def test_suffix_array_native_parity(monkeypatch) -> None:
    rng = np.random.default_rng(11)
    for n in (1, 2, 5, 97, 2000):
        text = rng.integers(0, 4, n).astype(np.int64)
        assert native.suffix_array_native(text) is not None, "the port's suffix library did not build"
        got_native = suffix_array(text)
        assert np.array_equal(got_native, jax_suffix.suffix_array(text)), n
        lcp_native = lcp_array(text, got_native)
        assert np.array_equal(lcp_native, jax_suffix.lcp_array(text, got_native)), n
        # the port's numpy prefix doubling and LCP for the same input
        monkeypatch.setattr(native, "suffix_array_native", lambda _t: None)
        monkeypatch.setattr(native, "kasai_lcp_native", lambda _t, _s: None)
        got_numpy = suffix_array(text)
        lcp_numpy = lcp_array(text, got_native)
        monkeypatch.undo()
        assert np.array_equal(got_native, got_numpy), n
        assert np.array_equal(lcp_native, lcp_numpy), n
        if n <= 100:
            assert np.array_equal(got_native, _py_suffix_array(text)), n


def test_suffix_array_native_sentinels() -> None:
    """Large symbols as maximal_matches uses them (separators, unique Ns)."""
    text = np.array([0, 1, 2, 3, 96, 2, 1, 0, 100, 101, 0, 1, 2, 97], np.int64)
    sa = suffix_array(text)
    assert np.array_equal(sa, _py_suffix_array(text))
    assert np.array_equal(sa, jax_suffix.suffix_array(text))
    lcp = lcp_array(text, sa)
    assert np.array_equal(lcp, jax_suffix.lcp_array(text, sa))
    for r in range(1, text.size):  # brute-force LCP
        i, j = sa[r - 1], sa[r]
        h = 0
        while i + h < text.size and j + h < text.size and text[i + h] == text[j + h]:
            h += 1
        assert lcp[r] == h, r


def test_band_dp_native_parity() -> None:
    assert native._load_band() is not None, "the port's band library did not build"
    for trial, (a, b, band) in enumerate(band_dp_trials()):
        for free_end in (False, True):
            got = _band_dp(a, b, band=band, free_end=free_end)
            want = _band_dp(a, b, band=band, free_end=free_end, force_numpy=True)
            assert got == want == jax_extend._band_dp(a, b, band=band, free_end=free_end), (trial, band, free_end)


def test_band_trials_through_the_extension_dispatch(one_torch_thread) -> None:
    tasks = [(a, b) for a, b, _band in band_dp_trials()]
    got = ext.batch_extend(tasks, "cpu")
    assert got == ext.batch_extend_host(tasks)
    for idx, (a, b) in enumerate(tasks):
        i, j, _score, err, nid, gap = jax_native.band_dp_native(
            a, b, ext.BAND, True, ext.MATCH, ext.MISMATCH, ext.OPEN, ext.EXTEND, ext.STOP_ROWS
        )
        assert got[idx] == (i, j, err, nid, gap), idx


def test_fastani_winnow_native_parity() -> None:
    from pyani_plus_tpu_torch.ops.minimizers import window_minimizers_numpy

    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    for _ in range(25):
        seq = bytes(rng.choice(alphabet, size=int(rng.integers(5, 4000))))
        k, w = int(rng.integers(4, 20)), int(rng.integers(1, 30))
        oracle = window_minimizers_numpy(seq, k, w)
        arrays = native.fastani_winnow_native(seq, k, w)
        assert arrays is not None
        for got, jax, want in zip(arrays, jax_native.fastani_winnow_native(seq, k, w),
                                  (oracle.hashes, oracle.positions, oracle.strands,
                                   oracle.first_steps, oracle.last_steps)):  # fmt: skip
            assert np.array_equal(got, want) and np.array_equal(got, jax)


def test_fastani_eval_region_native_parity() -> None:
    from pyani_plus_tpu_torch.ops.fastani_map import _evaluate_region_numpy

    rng = np.random.default_rng(11)
    for _ in range(40):
        qh = np.unique(rng.integers(0, 400, size=int(rng.integers(1, 100))).astype(np.uint64))
        ne = int(rng.integers(1, 150))
        eh = rng.integers(0, 400, size=ne).astype(np.uint64)
        ef = np.sort(rng.integers(0, 300, size=ne))
        el = ef + rng.integers(0, 40, size=ne)
        w_steps = int(rng.integers(1, 80))
        ev = np.unique(np.clip(np.concatenate([ef - w_steps + 1, el + 1, [0]]), 0, 400))
        s = int(rng.integers(1, qh.size + 1))
        expected = _evaluate_region_numpy(qh, eh, ef, el, ev, w_steps, s)
        got = native.fastani_eval_region_native(qh, eh, ef, el, ev, w_steps, s)
        assert got == expected == jax_native.fastani_eval_region_native(qh, eh, ef, el, ev, w_steps, s)


def test_fastani_map_fragment_native_parity() -> None:
    from pyani_plus_tpu_torch.ops.fastani_map import RefIndex, _search_mappings_numpy, n_window_steps
    from pyani_plus_tpu_torch.ops.minimizers import window_minimizers

    rng = np.random.default_rng(13)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.choice(bases, size=20000)
    mut = base.copy()
    flips = rng.random(base.size) < 0.05
    mut[flips] = rng.choice(bases, size=int(flips.sum()))
    other = rng.choice(bases, size=15000)  # a mutated copy and an unrelated sequence
    ref = RefIndex.build([bytes(mut), bytes(other)], k=16, w=24)
    w_steps = n_window_steps(3000, 16, 24)
    fields = ("hashes", "first_steps", "last_steps", "seq_ids", "hashes_sorted", "sorted_entry",
              "seq_lo_arr", "seq_hi_arr", "seq_ids_arr")  # fmt: skip
    arrays = [getattr(ref, name) for name in fields]
    mapped = 0
    for start in range(0, 18000, 2500):
        mins = window_minimizers(bytes(base[start : start + 3000]), 16, 24)
        if mins.count == 0:
            continue
        qh = np.unique(mins.hashes)
        s = int(qh.size)
        expected = tuple(_search_mappings_numpy(qh, ref, w_steps, s, 3000, 23))
        got = native.fastani_map_fragment_native(qh, *arrays, w_steps, s, 3000, 23)
        assert tuple(got) == expected
        assert tuple(got) == tuple(jax_native.fastani_map_fragment_native(qh, *arrays, w_steps, s, 3000, 23))
        mapped += 1
    assert mapped
