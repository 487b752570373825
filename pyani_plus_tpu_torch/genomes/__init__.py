"""Genome ingestion and 2-bit packed representation.

This layer turns FASTA files (possibly gzipped) into content-addressed,
numerics-ready genome objects:

- identity = MD5 of the decompressed file bytes (ref: utils.py:142-196), so
  results are cacheable across renames/moves, exactly like the reference;
- each sequence is encoded as a ``uint8`` code array with A/C/G/T -> 0/1/2/3
  and anything else (N, IUPAC ambiguity; lowercase folds to uppercase
  first) -> a per-letter code >= 4, which downstream kernels treat as a
  hard mask while tracebacks keep blastn's letter-equality identities;
- genome-level metadata (length, description) mirrors the reference's
  ``Genome`` ORM row (db_orm.py:103-145).

The packed arrays feed the JAX/Pallas kernels in ``pyani_plus_tpu_torch.ops``.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from pyani_plus_tpu_torch.utils import fasta_bytes_iterator, file_md5sum

# Encoding table: ASCII byte -> uint8 code. A/C/G/T (either case) ->
# 0..3; every other IUPAC/unknown LETTER -> its uppercase ASCII value
# (65..89, all >= 4 so every kernel's ambiguity mask still fires, yet
# DISTINCT per letter so letter-equality semantics -- blastn counts
# N==N as an identity but W vs R as a mismatch -- fall out of plain
# code equality in the alignment tracebacks); any non-letter byte (or
# 'Z', which no downstream symbol range reserves) -> 4.
CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4
_ENCODE = np.full(256, CODE_N, dtype=np.uint8)
for _c in range(ord("A"), ord("Z")):  # letters A..Y keep their identity
    _ENCODE[_c] = _c
    _ENCODE[_c + 32] = _c  # lowercase folds to uppercase
for _i, _c in enumerate(b"ACGT"):
    _ENCODE[_c] = _i
    _ENCODE[_c + 32] = _i  # lowercase
_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# IUPAC complement on the code domain: 2-bit codes complement as 3-c;
# ambiguity letters map pairwise (R<->Y, K<->M, B<->V, D<->H; S, W, N
# self); other letters (incl. the catch-all code 4) stay themselves.
_COMPLEMENT = np.arange(256, dtype=np.uint8)
_COMPLEMENT[:4] = [3, 2, 1, 0]
for _a, _b in (b"RY", b"KM", b"BV", b"DH"):
    _COMPLEMENT[_a] = _b
    _COMPLEMENT[_b] = _a


def encode_sequence(seq: bytes) -> np.ndarray:
    """Encode a DNA sequence (bytes) to uint8 codes.

    0..3 = A/C/G/T; >= 4 = masked/ambiguous (the letter's uppercase
    ASCII value, so distinct ambiguity letters stay distinguishable).

    >>> encode_sequence(b"ACGTacgtN-W").tolist()
    [0, 1, 2, 3, 0, 1, 2, 3, 78, 4, 87]
    """
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_sequence(codes: np.ndarray) -> bytes:
    """Decode uint8 codes back to uppercase ASCII bytes.

    Ambiguity letters round-trip; the catch-all code 4 decodes as N.

    >>> decode_sequence(encode_sequence(b"acgtNRw-"))
    b'ACGTNRWN'
    """
    codes = np.asarray(codes, dtype=np.uint8)
    return np.where(
        codes > CODE_N, codes, _DECODE[np.minimum(codes, CODE_N)]
    ).astype(np.uint8).tobytes()


def complement_codes(codes: np.ndarray) -> np.ndarray:
    """IUPAC complement on codes (A<->T, C<->G, R<->Y, ...); 4 stays 4.

    >>> decode_sequence(complement_codes(encode_sequence(b"ACGTNRW")))
    b'TGCANYW'
    """
    return _COMPLEMENT[codes]


@dataclass(frozen=True)
class SequenceRecord:
    """One FASTA record: description line + encoded sequence."""

    title: bytes  # full description line after '>'
    codes: np.ndarray  # uint8 codes, 0..3 valid, 4 masked

    @property
    def identifier(self) -> bytes:
        """First word of the description (the sequence id)."""
        return self.title.split(None, 1)[0] if self.title else b""

    def __len__(self) -> int:
        return int(self.codes.size)


@dataclass
class Genome:
    """A genome: content MD5 identity plus its encoded sequences."""

    md5: str
    path: Path
    records: list[SequenceRecord] = field(repr=False)

    @property
    def length(self) -> int:
        """Total number of bases over all sequences (ref db_orm.py:130)."""
        return sum(len(rec) for rec in self.records)

    @property
    def description(self) -> str:
        """Description of the first sequence (ref db_orm.py:810-822)."""
        return self.records[0].title.decode(errors="replace") if self.records else ""

    @property
    def n_sequences(self) -> int:
        return len(self.records)


def load_genome(path: Path | str, md5: str | None = None) -> Genome:
    """Load a FASTA file (gzip transparent) into a :class:`Genome`.

    Mirrors the reference's ingest checks (db_genome,
    db_orm.py:835-877): compression must agree with the extension --
    gzip data without a ``.gz`` name or a ``.gz`` name over plain text
    is an error, as is gzip data with no FASTA record at all.  A PLAIN
    file with no FASTA record silently ingests as an empty genome, as
    the reference's check lives only in its gzip branch.
    """
    path = Path(path)
    if md5 is None:
        md5 = file_md5sum(path)
    records: list[SequenceRecord] = []
    try:
        with gzip.open(path, "rb") as handle:
            for title, seq in fasta_bytes_iterator(handle):
                records.append(SequenceRecord(title, encode_sequence(seq)))
        if not records:
            msg = f"File {path.name} is not recognised as a FASTA record"
            raise ValueError(msg)
        if not path.name.endswith(".gz"):
            msg = f"No .gz ending, but {path.name} is gzip compressed"
            raise ValueError(msg)
    except gzip.BadGzipFile:
        if path.name.endswith(".gz"):
            msg = f"Has .gz ending, but {path.name} is NOT gzip compressed"
            raise ValueError(msg) from None
        with path.open("rb") as handle:
            for title, seq in fasta_bytes_iterator(handle):
                records.append(SequenceRecord(title, encode_sequence(seq)))
    return Genome(md5=md5, path=path, records=records)
