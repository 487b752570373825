"""The port's MurmurHash3 (int64 bit patterns) against the JAX package's.

``murmur64_torch`` must equal ``murmur64_numpy`` (uint64) and
``murmur64_jax`` ((hi, lo) uint32 words) bit for bit, at every tail
length of the hash and for hashes of 2^63 and above, whose int64 pattern
is negative. Inputs come from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyani_plus_tpu.ops.murmur3 import murmur64_jax, murmur64_numpy
from pyani_plus_tpu_torch.ops.murmur3 import murmur64_torch, to_uint64

LENGTHS = (1, 7, 8, 15, 16, 17, 24, 31, 32, 33, 48, 100)  # tests/test_murmur3.py


def _jax_hash(data: np.ndarray) -> np.ndarray:
    hi, lo = murmur64_jax(data)
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


@pytest.mark.parametrize("length", LENGTHS)
def test_murmur64_torch_matches_numpy_and_jax(length: int) -> None:
    rng = np.random.default_rng(42 + length)
    data = rng.integers(0, 256, size=(64, length), dtype=np.uint8)
    got = to_uint64(murmur64_torch(torch.from_numpy(data)))
    assert got.dtype == np.uint64
    assert np.array_equal(got, murmur64_numpy(data))
    assert np.array_equal(got, _jax_hash(data))
    # rows whose hash is 2^63 or more (negative as int64) are among them
    assert (got >= np.uint64(1 << 63)).any()
    assert (got < np.uint64(1 << 63)).any()


def test_murmur64_torch_kmers_seed_and_shapes() -> None:
    """ASCII k-mers as sourmash hashes them, a 1-D row, another seed; rows
    of no bytes or of another type raise."""
    kmer = np.frombuffer(b"ACGTACGTACGTACGTACGTACGTACGTACG", dtype=np.uint8)
    one = to_uint64(murmur64_torch(torch.from_numpy(kmer.copy())))
    assert np.array_equal(one, murmur64_numpy(kmer))
    rows = np.stack([kmer, kmer[::-1]])
    for seed in (42, 43, 0):
        got = to_uint64(murmur64_torch(torch.from_numpy(rows.copy()), seed=seed))
        assert np.array_equal(got, murmur64_numpy(rows, seed=seed))
    with pytest.raises(ValueError, match="0 bytes"):
        murmur64_torch(torch.zeros((3, 0), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        murmur64_torch(torch.zeros((2, 4), dtype=torch.int64))


@pytest.mark.gpu
def test_murmur64_torch_on_the_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    for length in LENGTHS:
        data = rng.integers(0, 256, size=(4096, length), dtype=np.uint8)
        got = to_uint64(murmur64_torch(torch.from_numpy(data).cuda()))
        assert np.array_equal(got, murmur64_numpy(data)), length
