"""Canonical k-mer enumeration over encoded genome sequences.

The sketching methods (sourmash FracMinHash, and later skani seeding) hash
the *canonical* form of each k-mer: the lexicographically smaller of the
k-mer and its reverse complement, as uppercase ASCII bytes. Because the
byte order of "ACGT" is monotone in the 2-bit code order 0..3, canonical
selection can be done by comparing 2-bit packed integers instead of byte
strings -- one uint64 compare per window instead of up to k byte compares.

K-mers containing any non-ACGT character are skipped (sourmash's
force-mode behaviour; such windows never contribute hashes).
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu_torch.genomes import CODE_N, _DECODE
from pyani_plus_tpu_torch.ops.murmur3 import murmur64_numpy

_MAX_PACK_K = 32  # 2*k bits must fit in uint64


def _window_validity(codes: np.ndarray, k: int) -> np.ndarray:
    """Boolean array over windows: True iff all k codes are A/C/G/T."""
    invalid = (codes >= CODE_N).astype(np.int64)
    csum = np.concatenate(([0], np.cumsum(invalid)))
    return (csum[k:] - csum[:-k]) == 0


def packed_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (fwd, rc) 2-bit packed uint64 values for every window.

    ``fwd[i]`` packs codes[i:i+k] big-endian (first base in the high bits),
    so integer order == lexicographic byte order. ``rc[i]`` packs the
    reverse complement the same way. Windows containing masked codes give
    garbage values -- callers must mask with :func:`_window_validity`.
    """
    if k > _MAX_PACK_K:
        msg = f"k={k} exceeds packing limit {_MAX_PACK_K}"
        raise ValueError(msg)
    n_windows = codes.size - k + 1
    if n_windows <= 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    c = codes.astype(np.uint64)
    fwd = np.zeros(n_windows, dtype=np.uint64)
    rc = np.zeros(n_windows, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(k):
            fwd |= (c[j : j + n_windows] & np.uint64(3)) << np.uint64(2 * (k - 1 - j))
            rc |= ((np.uint64(3) - (c[j : j + n_windows] & np.uint64(3)))) << np.uint64(
                2 * j
            )
    return fwd, rc


def canonical_kmer_hashes(
    codes: np.ndarray, k: int, *, chunk: int = 1 << 20
) -> np.ndarray:
    """MurmurHash3-64 (seed 42) of every valid canonical k-mer of one sequence.

    Returns an (n_valid_windows,) uint64 array in window order (NOT deduped,
    NOT sorted). Equivalent to sourmash's per-sequence ``seq_to_hashes``
    with force=True skipping invalid k-mers.
    """
    n_windows = codes.size - k + 1
    if n_windows <= 0:
        return np.empty(0, np.uint64)
    valid = _window_validity(codes, k)
    fwd, rc = packed_kmers(codes, k)
    take_rc = rc < fwd

    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return np.empty(0, np.uint64)

    out = np.empty(idx.size, dtype=np.uint64)
    fwd_bytes_full = _DECODE[np.minimum(codes, CODE_N)]
    rc_codes = (np.uint8(3) - np.minimum(codes, 3)).astype(np.uint8)
    rc_bytes_full = _DECODE[rc_codes]

    for start in range(0, idx.size, chunk):
        sel = idx[start : start + chunk]
        # Build the (m, k) canonical byte matrix for this chunk.
        offs = sel[:, None] + np.arange(k)[None, :]
        fwd_mat = fwd_bytes_full[offs]
        rc_mat = rc_bytes_full[offs[:, ::-1]]
        mat = np.where(take_rc[sel, None], rc_mat, fwd_mat)
        out[start : start + chunk] = murmur64_numpy(mat)
    return out
