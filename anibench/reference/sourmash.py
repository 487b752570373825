"""Plain reference of sourmash's FracMinHash containment ANI.

Each genome's sketch is the set of MurmurHash3 x64-128 hashes (first 64
bits, seed 42) of its canonical k-mers, as uppercase ASCII, that are at
most ``round(2**64 / scaled)``; a k-mer holding any letter other than A,
C, G, T is skipped. The hashing runs in plain PyTorch (the hash written
again on int64 bit patterns), the intersections in numpy on the sorted
sets. For a query Q and subject S, with c = |Q n S| / |Q|:
identity = max(c(Q, S), c(S, Q)) ** (1 / k), query coverage =
c(Q, S) ** (1 / k), and both are absent when nothing is shared.
It imports nothing of the program and reads only the FASTA files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from anibench.reference.fasta import read_genome

_ASCII = (ord("A"), ord("C"), ord("G"), ord("T"))
_CHUNK = 1 << 22  # windows hashed per call


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


_C1 = _signed(0x87C37B91114253D5)
_C2 = 0x4CF5AD432745937F
_F1 = _signed(0xFF51AFD7ED558CCD)
_F2 = _signed(0xC4CEB9FE1A85EC53)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _shr(k, 33)
    k = k * _F1
    k = k ^ _shr(k, 33)
    k = k * _F2
    return k ^ _shr(k, 33)


def murmur64(words: list[torch.Tensor], length: int, seed: int = 42) -> torch.Tensor:
    """MurmurHash3 x64-128's first word of rows of ``length`` bytes given
    as little-endian int64 words (bytes past ``length`` zero)."""
    h1 = torch.full_like(words[0], seed)
    h2 = h1.clone()
    nblocks = length // 16
    for b in range(nblocks):
        k1 = _rotl(words[2 * b] * _C1, 31) * _C2
        h1 = _rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = _rotl(words[2 * b + 1] * _C2, 33) * _C1
        h2 = _rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    tail = length & 15
    if tail > 8:
        h2 = h2 ^ (_rotl(words[2 * nblocks + 1] * _C2, 33) * _C1)
    if tail > 0:
        h1 = h1 ^ (_rotl(words[2 * nblocks] * _C1, 31) * _C2)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


def max_hash(scaled: int) -> int:
    return 2**64 - 1 if scaled == 1 else min(round(2**64 / scaled), 2**64 - 1)


def _record_hashes(codes: np.ndarray, k: int, limit: int, device: torch.device) -> np.ndarray:
    if codes.size < k:
        return np.empty(0, np.uint64)
    c = torch.as_tensor(codes, device=device)
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), torch.cumsum((c >= 4).long(), 0)])
    out = []
    for start in range(0, codes.size - k + 1, _CHUNK):
        w = min(_CHUNK, codes.size - k + 1 - start)
        valid = (bad[start + k : start + k + w] - bad[start : start + w]) == 0
        fwd_codes = c[start : start + w + k - 1].clamp(max=3).long()
        rev_codes = 3 - fwd_codes
        fwd = torch.zeros(w, dtype=torch.int64, device=device)
        rev = torch.zeros(w, dtype=torch.int64, device=device)
        for j in range(k):  # 2-bit packs; k <= 31 keeps them below 2^62
            fwd |= fwd_codes[j : j + w] << (2 * (k - 1 - j))
            rev |= rev_codes[j : j + w] << (2 * j)
        take_rc = rev < fwd
        ascii_ = torch.tensor(_ASCII, dtype=torch.int64, device=device)
        fwd_bytes, rev_bytes = ascii_[fwd_codes], ascii_[rev_codes]
        words = []
        for base in range(0, k, 8):
            wf = torch.zeros(w, dtype=torch.int64, device=device)
            wr = torch.zeros(w, dtype=torch.int64, device=device)
            for t in range(min(8, k - base)):
                p = base + t
                wf |= fwd_bytes[p : p + w] << (8 * t)
                wr |= rev_bytes[k - 1 - p : k - 1 - p + w] << (8 * t)
            words.append(torch.where(take_rc, wr, wf))
        hashes = murmur64(words, k)
        # unsigned order on int64 bit patterns: flip the sign bit
        keep = valid & ((hashes ^ (-(1 << 63))) <= _signed(limit ^ (1 << 63)))
        out.append(hashes[keep].cpu().numpy().view(np.uint64))
    return np.concatenate(out)


def sketch(path: Path, k: int, scaled: int, device) -> tuple[str, np.ndarray]:
    """(MD5 of the file, the sorted set of kept hashes)."""
    genome = read_genome(path)
    if k > 31:
        raise ValueError("this reference packs k-mers of at most 31 letters")
    parts = [_record_hashes(rec, k, max_hash(scaled), torch.device(device)) for rec in genome.records]
    return genome.md5, np.unique(np.concatenate(parts)) if parts else np.empty(0, np.uint64)


def compute(paths: list[Path], pairs: list[tuple[int, int]], device, params: dict) -> dict[tuple[int, int], dict]:
    """The reference rows of the ordered pairs (query, subject), for the
    ``kmersize`` and ``scaled`` of ``params``."""
    return rows(prepare(paths, pairs, device, params), np.float64)


def prepare(paths: list[Path], pairs: list[tuple[int, int]], device, params: dict):
    """Each pair's shared hashes and the two sketch sizes, and k."""
    k, scaled = params["kmersize"], params["scaled"]
    need = sorted({i for pair in pairs for i in pair})
    with torch.inference_mode():
        sets = {i: sketch(paths[i], k, scaled, device)[1] for i in need}
    counts = {
        (q, s): (np.intersect1d(sets[q], sets[s], assume_unique=True).size, sets[q].size, sets[s].size)
        for q, s in pairs
    }
    return counts, k


def rows(state, dtype) -> dict[tuple[int, int], dict]:
    """identity = max(c(Q, S), c(S, Q)) ** (1 / k) and query coverage =
    c(Q, S) ** (1 / k), in ``dtype``; absent when nothing is shared."""
    counts, k = state
    power = dtype(1.0) / dtype(k)
    out = {}
    for pair, (shared, size_q, size_s) in counts.items():
        if shared == 0 or size_q == 0 or size_s == 0:
            identity = cov = None
        else:
            c_q = dtype(shared) / dtype(size_q)
            c_s = dtype(shared) / dtype(size_s)
            identity = float(np.power(max(c_q, c_s), power))
            cov = float(np.power(c_q, power))
        out[pair] = {"identity": identity, "cov_query": cov, "aln_length": None, "sim_errors": None, "cov_subject": None}
    return out
