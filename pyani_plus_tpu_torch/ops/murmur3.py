"""MurmurHash3 x64-128 (first 64 bits, seed 42) in PyTorch, on any device.

Port of ``murmur64_jax`` (``pyani_plus_tpu/ops/murmur3.py``), the hash
that sourmash's FracMinHash keeps. The oracle is the JAX package's
``murmur64_numpy``; the two agree bit for bit.

PyTorch's ``uint64`` has no multiply, shifts or CUDA compares to rely on,
so a 64-bit word is an ``int64`` tensor read as its raw bit pattern:
addition, multiplication, xor and the left shift wrap exactly as uint64
arithmetic does, and a right shift is made logical by masking off the
sign bits it copies. Constants of 2^63 and above are written as their
signed values. ``to_uint64`` turns a result into numpy's ``uint64``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["murmur64_torch", "murmur64_words", "signed64", "to_uint64"]


def signed64(x: int) -> int:
    """The int64 with the bit pattern of the uint64 ``x``."""
    return x - (1 << 64) if x >= 1 << 63 else x


_C1 = signed64(0x87C37B91114253D5)
_C2 = 0x4CF5AD432745937F
_F1 = signed64(0xFF51AFD7ED558CCD)
_F2 = signed64(0xC4CEB9FE1A85EC53)
_N1 = 0x52DCE729
_N2 = 0x38495AB5


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of the 64-bit pattern (0 < r < 64)."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _shr(k, 33)
    k = k * _F1
    k = k ^ _shr(k, 33)
    k = k * _F2
    return k ^ _shr(k, 33)


def murmur64_words(words: list[torch.Tensor], length: int, seed: int = 42) -> torch.Tensor:
    """The hash of rows of ``length`` bytes given as little-endian words.

    ``words[w]`` holds bytes ``8w .. 8w+7`` of every row as int64 (bytes
    past ``length`` zero), ``ceil(length / 8)`` words in all. Returns the
    int64 bit patterns of the hashes.
    """
    if length < 1 or len(words) != -(-length // 8):
        msg = f"{len(words)} words for {length} bytes"
        raise ValueError(msg)
    h1 = torch.full_like(words[0], seed)
    h2 = h1.clone()
    nblocks = length // 16
    for b in range(nblocks):
        k1 = _rotl(words[2 * b] * _C1, 31) * _C2
        h1 = _rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + _N1
        k2 = _rotl(words[2 * b + 1] * _C2, 33) * _C1
        h2 = _rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + _N2
    ntail = length & 15
    if ntail > 8:
        h2 = h2 ^ (_rotl(words[2 * nblocks + 1] * _C2, 33) * _C1)
    if ntail > 0:
        h1 = h1 ^ (_rotl(words[2 * nblocks] * _C1, 31) * _C2)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


def _le_words(data: torch.Tensor) -> list[torch.Tensor]:
    """(N, L) uint8 rows as ``ceil(L / 8)`` little-endian int64 words."""
    wide = data.to(torch.int64)
    length = data.shape[1]
    words = []
    for base in range(0, length, 8):
        word = wide[:, base]
        for i in range(1, min(8, length - base)):
            word = word | (wide[:, base + i] << (8 * i))
        words.append(word)
    return words


def murmur64_torch(data: torch.Tensor, seed: int = 42) -> torch.Tensor:
    """Batch MurmurHash3 x64-128 (low word) of N equal-length byte rows.

    ``data`` is an (N, L) (or (L,)) uint8 tensor on any device, L >= 1
    (a k-mer has at least one letter). Returns
    the (N,) int64 bit patterns of the hashes on the same device;
    ``to_uint64`` gives ``murmur64_numpy``'s uint64 array.
    """
    if data.dtype != torch.uint8:
        msg = f"murmur64_torch takes uint8 rows, got {data.dtype}"
        raise TypeError(msg)
    if data.dim() == 1:
        data = data[None, :]
    return murmur64_words(_le_words(data), data.shape[1], seed)


def to_uint64(hashes: torch.Tensor) -> np.ndarray:
    """int64 bit patterns (any device) as a numpy uint64 array."""
    return hashes.cpu().numpy().view(np.uint64)
