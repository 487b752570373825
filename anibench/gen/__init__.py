"""The benchmark's genome collections, made from a seed.

``related_genomes``, ``mutate``, ``salt`` and ``write_fasta`` are frozen
copies of ``pyani_plus_tpu_torch/synthetic.py``'s (genomes from one
random ancestor at given substitution rates, indels at rate/20, runs of
N and scattered IUPAC letters), kept here so that a change to the program
cannot change the benchmark's inputs. ``write_collection`` reads a
workload's ``collection`` block:

- ``clades``: unrelated ancestors; ``per_clade``: descendants of each;
- ``length``: the ancestor's length in bases;
- ``rates``: ``[low, high]``: each clade's descendants take the rates
  ``linspace(low, high, per_clade)``, which the seed shuffles, so every
  seed gets the same amount of divergence and the same work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_IUPAC = np.frombuffer(b"RYKMSWBDHV", dtype=np.uint8)


def mutate(seq: np.ndarray, rate: float, rng: np.random.Generator) -> np.ndarray:
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


def related_genomes(length: int, rates: list[float], rng: np.random.Generator) -> list[np.ndarray]:
    """One ASCII genome per substitution rate, from one shared ancestor."""
    ancestor = _BASES[rng.integers(0, 4, length)]
    genomes = []
    for rate in rates:
        genome = mutate(ancestor, rate, rng) if rate else ancestor.copy()
        salt(genome, rng)
        genomes.append(genome)
    return genomes


def write_fasta(path: Path, name: str, seq: np.ndarray, width: int = 80) -> Path:
    raw = seq.tobytes()
    lines = [f">{name} synthetic".encode(), *(raw[i : i + width] for i in range(0, len(raw), width))]
    path.write_bytes(b"\n".join(lines) + b"\n")
    return path


def rng_for(seed: int, *key: int) -> np.random.Generator:
    """A generator for `seed` (any integer) and a path of sub-keys."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *key]))


def collection_genomes(collection: dict, seed: int, clade: int) -> list[tuple[str, np.ndarray]]:
    """The (name, ASCII sequence) genomes of one clade."""
    rng = rng_for(seed, clade)
    low, high = collection["rates"]
    rates = np.linspace(low, high, collection["per_clade"])[rng.permutation(collection["per_clade"])]
    genomes = related_genomes(collection["length"], [float(r) for r in rates], rng)
    return [(f"clade_{clade}_genome_{idx}", seq) for idx, seq in enumerate(genomes)]


def write_collection(collection: dict, seed: int, directory: Path) -> list[Path]:
    """Write the workload's collection as one FASTA file a genome; returns
    the paths in clade order. Clades are made side by side, each from its
    own generator, so the bytes do not depend on the order they finish in."""
    from concurrent.futures import ThreadPoolExecutor

    directory.mkdir(parents=True, exist_ok=True)

    def clade_files(clade: int) -> list[Path]:
        return [write_fasta(directory / f"{name}.fna", name, seq) for name, seq in collection_genomes(collection, seed, clade)]

    with ThreadPoolExecutor(max_workers=min(4, collection["clades"])) as pool:
        return [path for paths in pool.map(clade_files, range(collection["clades"])) for path in paths]


def truncated_copy(path: Path, directory: Path, length: int) -> Path:
    """A copy of a one-record FASTA file of this module's, cut to its first
    ``length`` letters, in ``directory``."""
    directory.mkdir(parents=True, exist_ok=True)
    lines = path.read_bytes().split(b"\n")
    seq = np.frombuffer(b"".join(lines[1:])[:length], dtype=np.uint8)
    return write_fasta(directory / path.name, path.stem, seq)
