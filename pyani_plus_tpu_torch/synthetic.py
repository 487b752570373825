"""Synthetic related genomes and sketches for parity tests and the card smoke run.

Genomes descend from one random ancestor (one per clade in
``write_clade_dir``) at given substitution rates
(as ``bench.mutate`` does), plus short indels so that the gap states of
the alignment DP are exercised, runs of N and scattered IUPAC letters so
that codes >= 4 are too. FracMinHash sketch sets for the membership Gram
are drawn directly as hash sets. Everything comes from one numpy seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pyani_plus_tpu_torch.ops.minhash import Sketch

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


def write_clade_dir(
    directory: Path, length: int, clades: int, rates: list[float], seed: int
) -> list[Path]:
    """FASTA files clade_{c}_genome_{i}.fna in `directory`: `clades`
    unrelated ancestors (seeds seed, seed + 1, ...), each with one
    descendant per rate."""
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for clade in range(clades):
        for idx, seq in enumerate(related_genomes(length, rates, seed + clade)):
            name = f"clade_{clade}_genome_{idx}"
            paths.append(write_fasta(directory / f"{name}.fna", name, seq))
    return paths


def _sketch(name: str, hashes: np.ndarray) -> Sketch:
    return Sketch(md5=name, ksize=31, scaled=1000, hashes=np.unique(hashes.astype(np.uint64)))


def _hashes(rng: np.random.Generator, size: int, low: int = 0) -> np.ndarray:
    return rng.integers(low, 2**64, size, dtype=np.uint64)


def gram_fuzz_sets(seed: int, n: int) -> dict[str, list[Sketch]]:
    """Sketch sets that hold the membership Gram's counts to exactness.

    - ``pool``: `n` sketches of 1,100-3,500 hashes from one pool of
      4,000, all in one block of 4,096 ids: pair counts of about
      300-3,000, past bf16's 256 and fp16's 2,048;
    - ``core``: a shared core of 20,000 hashes below 2^62, so that its
      ids fill whole blocks; two sketches hold all of it, so a block
      counts 4,096 for them, and the others 55-95% of it plus private
      hashes above 2^62, so their blocks count odd numbers above 2,048;
    - ``empty``: empty sketches beside small ones, and a set of empty
      sketches only;
    - ``high``: hashes of 2^63 and above beside ones below.
    """
    rng = np.random.default_rng(seed)
    pool = _hashes(rng, 4000)
    core = rng.integers(0, 2**62, 20_000, dtype=np.uint64)
    m = max(4, n // 4)
    sets = {
        "pool": [
            _sketch(f"pool{i}", rng.choice(pool, int(rng.integers(1100, 3501)), replace=False))
            for i in range(n)
        ],
        "core": [_sketch("core0", core), _sketch("core1", core)]
        + [
            _sketch(
                f"core{i}",
                np.concatenate(
                    [core[rng.random(core.size) < rng.uniform(0.55, 0.95)],
                     _hashes(rng, int(rng.integers(0, 3000)), low=2**62)]
                ),
            )
            for i in range(2, m)
        ],
        "empty": [
            _sketch(f"empty{i}", core[: int(rng.integers(1, 50))] if i % 3 else core[:0])
            for i in range(m)
        ],
        "all_empty": [_sketch(f"none{i}", core[:0]) for i in range(3)],
    }
    mixed = _hashes(rng, 10_000)
    high = mixed[mixed >= np.uint64(1 << 63)]
    low = mixed[mixed < np.uint64(1 << 63)]
    sets["high"] = [_sketch("high0", high[:3000]), _sketch("high1", high[1000:5000])] + [
        _sketch(f"high{i}", np.concatenate([high[rng.random(high.size) < 0.5], low[: 100 * i]]))
        for i in range(2, m)
    ]
    return sets


def clade_sketches(
    seed: int, n: int, clades: int, core: int = 3500, sizes: tuple[int, int] = (4000, 6000)
) -> list[Sketch]:
    """`n` sketches in `clades` clades: each holds 70-100% of its clade's
    core of `core` hashes, filled up with private hashes to a size drawn
    from `sizes`. Sketches of different clades share nothing."""
    rng = np.random.default_rng(seed)
    cores = [_hashes(rng, core) for _ in range(clades)]
    out = []
    for i in range(n):
        own = cores[i % clades]
        shared = own[rng.random(own.size) < rng.uniform(0.7, 1.0)]
        size = int(rng.integers(sizes[0], sizes[1] + 1))
        out.append(_sketch(f"sketch{i}", np.concatenate([shared, _hashes(rng, max(0, size - shared.size))])))
    return out
