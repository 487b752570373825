"""Synthetic related genomes for parity tests and the card smoke run.

Genomes descend from one random ancestor at given substitution rates
(as ``bench.mutate`` does), plus short indels so that the gap states of
the alignment DP are exercised, runs of N and scattered IUPAC letters so
that codes >= 4 are too. Everything comes from one numpy seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_IUPAC = np.frombuffer(b"RYKMSWBDHV", dtype=np.uint8)


def mutate(
    seq: np.ndarray, rate: float, rng: np.random.Generator
) -> np.ndarray:
    """Substitute a `rate` share of the letters; add indels at rate/20."""
    out = seq.copy()
    codes = np.searchsorted(_BASES, out)  # A C G T -> 0..3
    mut = rng.random(out.size) < rate
    codes[mut] = (codes[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    out[mut] = _BASES[codes[mut]]
    n_indels = int(out.size * rate / 20)
    pieces = []
    start = 0
    for pos in np.sort(rng.choice(out.size, n_indels, replace=False)):
        pieces.append(out[start:pos])
        size = int(rng.integers(1, 6))
        if rng.random() < 0.5:  # insertion
            pieces.append(_BASES[rng.integers(0, 4, size)])
            start = pos
        else:  # deletion
            start = min(out.size, pos + size)
    pieces.append(out[start:])
    return np.concatenate(pieces)


def salt(seq: np.ndarray, rng: np.random.Generator, n_runs: int = 4) -> None:
    """In place: a few runs of N (20-200 long) and some IUPAC letters."""
    for _ in range(n_runs):
        size = int(rng.integers(20, 200))
        pos = int(rng.integers(0, max(1, seq.size - size)))
        seq[pos : pos + size] = ord("N")
    spots = rng.choice(seq.size, max(1, seq.size // 20000), replace=False)
    seq[spots] = _IUPAC[rng.integers(0, _IUPAC.size, spots.size)]


def related_genomes(
    length: int, rates: list[float], seed: int
) -> list[np.ndarray]:
    """One ASCII genome per substitution rate, from one shared ancestor."""
    rng = np.random.default_rng(seed)
    ancestor = _BASES[rng.integers(0, 4, length)]
    genomes = []
    for rate in rates:
        genome = mutate(ancestor, rate, rng) if rate else ancestor.copy()
        salt(genome, rng)
        genomes.append(genome)
    return genomes


def write_fasta(path: Path, name: str, seq: np.ndarray, width: int = 80) -> Path:
    lines = [f">{name} synthetic".encode()]
    raw = seq.tobytes()
    lines.extend(raw[i : i + width] for i in range(0, len(raw), width))
    path.write_bytes(b"\n".join(lines) + b"\n")
    return path


def write_genome_dir(
    directory: Path, length: int, rates: list[float], seed: int
) -> list[Path]:
    """FASTA files genome_0.fna, genome_1.fna, ... in `directory`."""
    directory.mkdir(parents=True, exist_ok=True)
    return [
        write_fasta(directory / f"genome_{idx}.fna", f"genome_{idx}", seq)
        for idx, seq in enumerate(related_genomes(length, rates, seed))
    ]
