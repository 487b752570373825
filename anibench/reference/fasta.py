"""FASTA files to the code arrays the references work on.

A plain reader of the benchmark's own FASTA files, and the letter codes
that pyANI-plus's methods define: A, C, G, T (either case) are 0..3; any
other letter A..Y is its uppercase ASCII value (65..89), so that two
ambiguity letters compare equal only when they are the same letter; any
other byte is 4. The genome's identity is the MD5 of its file's bytes,
as the store records it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ENCODE = np.full(256, 4, dtype=np.uint8)
for _c in range(ord("A"), ord("Z")):
    ENCODE[_c] = _c
    ENCODE[_c + 32] = _c
for _i, _c in enumerate(b"ACGT"):
    ENCODE[_c] = _i
    ENCODE[_c + 32] = _i

# Complement on the codes: 3 - c for A/C/G/T, R<->Y, K<->M, B<->V, D<->H,
# every other code itself.
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[:4] = [3, 2, 1, 0]
for _a, _b in (b"RY", b"KM", b"BV", b"DH"):
    COMPLEMENT[_a] = _b
    COMPLEMENT[_b] = _a


@dataclass
class Genome:
    md5: str
    name: str
    records: list[np.ndarray]  # uint8 codes, one array a sequence

    @property
    def length(self) -> int:
        return sum(int(rec.size) for rec in self.records)


def read_genome(path: Path) -> Genome:
    raw = path.read_bytes()
    records: list[np.ndarray] = []
    for chunk in raw.split(b">")[1:]:
        _title, _, body = chunk.partition(b"\n")
        seq = b"".join(body.split())
        records.append(ENCODE[np.frombuffer(seq, dtype=np.uint8)])
    return Genome(hashlib.md5(raw).hexdigest(), path.stem, records)  # noqa: S324


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes][::-1].copy()
