"""MurmurHash3 x64-128 (first 64 bits, seed 42) in PyTorch, on any device.

Port of ``pyani_plus_tpu/ops/murmur3.py``, the hash that sourmash's
FracMinHash keeps: ``murmur64_torch`` for ``murmur64_jax``, and
``murmur64_numpy``, the host version in uint64 arithmetic, which is the
oracle and the no-compiler route of host sketching. The two agree bit
for bit.

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

__all__ = [
    "murmur64_numpy",
    "murmur64_torch",
    "murmur64_words",
    "signed64",
    "to_uint64",
]


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


# ---------------------------------------------------------------------------
# Host numpy version: uint64 modular arithmetic over an (N, L) byte matrix.
# ---------------------------------------------------------------------------

_NP_C1 = np.uint64(0x87C37B91114253D5)
_NP_C2 = np.uint64(0x4CF5AD432745937F)
_NP_F1 = np.uint64(0xFF51AFD7ED558CCD)
_NP_F2 = np.uint64(0xC4CEB9FE1A85EC53)
_M5 = np.uint64(5)
_NP_N1 = np.uint64(0x52DCE729)
_NP_N2 = np.uint64(0x38495AB5)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r_ = np.uint64(r)
    inv = np.uint64(64 - r)
    return (x << r_) | (x >> inv)


def _fmix64(k: np.ndarray) -> np.ndarray:
    s33 = np.uint64(33)
    k ^= k >> s33
    k *= _NP_F1
    k ^= k >> s33
    k *= _NP_F2
    k ^= k >> s33
    return k


def _le_u64(block: np.ndarray) -> np.ndarray:
    """Assemble little-endian uint64 from an (..., 8) uint8 array."""
    block = np.ascontiguousarray(block)
    if block.strides[-1] == 1 and block.shape[-1] == 8:
        # Fast path: reinterpret 8 contiguous bytes as one LE uint64
        # (numpy is little-endian on all supported platforms here).
        # copy: callers mutate in place, and the source may be read-only
        return block.view("<u8").reshape(block.shape[:-1]).copy()
    out = np.zeros(block.shape[:-1], dtype=np.uint64)  # pragma: no cover
    for i in range(8):  # pragma: no cover
        out |= block[..., i].astype(np.uint64) << np.uint64(8 * i)
    return out  # pragma: no cover


def murmur64_numpy(data: np.ndarray, seed: int = 42) -> np.ndarray:
    """Batch MurmurHash3 x64-128 (low word) of N equal-length byte rows.

    ``data`` is an (N, L) uint8 array; returns an (N,) uint64 array equal to
    the first 64 bits of MurmurHash3_x64_128(row_bytes, seed) for each row.
    """
    if data.ndim == 1:
        data = data[None, :]
    n, length = data.shape
    with np.errstate(over="ignore"):
        h1 = np.full(n, np.uint64(seed), dtype=np.uint64)
        h2 = np.full(n, np.uint64(seed), dtype=np.uint64)

        nblocks = length // 16
        for b in range(nblocks):
            k1 = _le_u64(data[:, b * 16 : b * 16 + 8])
            k2 = _le_u64(data[:, b * 16 + 8 : b * 16 + 16])

            k1 *= _NP_C1
            k1 = _rotl64(k1, 31)
            k1 *= _NP_C2
            h1 ^= k1

            h1 = _rotl64(h1, 27)
            h1 += h2
            h1 = h1 * _M5 + _NP_N1

            k2 *= _NP_C2
            k2 = _rotl64(k2, 33)
            k2 *= _NP_C1
            h2 ^= k2

            h2 = _rotl64(h2, 31)
            h2 += h1
            h2 = h2 * _M5 + _NP_N2

        tail = data[:, nblocks * 16 :]
        ntail = length & 15
        if ntail > 0:
            k1 = np.zeros(n, dtype=np.uint64)
            k2 = np.zeros(n, dtype=np.uint64)
            for i in range(min(ntail, 8)):
                k1 |= tail[:, i].astype(np.uint64) << np.uint64(8 * i)
            for i in range(8, ntail):
                k2 |= tail[:, i].astype(np.uint64) << np.uint64(8 * (i - 8))
            if ntail > 8:
                k2 *= _NP_C2
                k2 = _rotl64(k2, 33)
                k2 *= _NP_C1
                h2 ^= k2
            k1 *= _NP_C1
            k1 = _rotl64(k1, 31)
            k1 *= _NP_C2
            h1 ^= k1

        ln = np.uint64(length)
        h1 ^= ln
        h2 ^= ln
        h1 += h2
        h2 += h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 += h2
        # h2 += h1  # second word unused; we return the first 64 bits
    return h1
