"""Synthetic related genomes and sketches for parity tests and the card smoke run.

Genomes descend from one random ancestor (one per clade in
``write_clade_dir``) at given substitution rates
(as ``substitute`` does), plus short indels so that the gap states of
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


def substitute(codes: np.ndarray, rate: float, rng: np.random.Generator) -> np.ndarray:
    """Substitute a `rate` share of 0-3 codes, nothing else: the root
    ``bench.py``'s ``mutate``, draw for draw."""
    out = codes.copy()
    mut = rng.random(out.size) < rate
    out[mut] = (out[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    return out


def mutate(
    seq: np.ndarray, rate: float, rng: np.random.Generator
) -> np.ndarray:
    """Substitute a `rate` share of the letters; add indels at rate/20."""
    return _mutate_tracked(seq, rate, rng)[0]


def _mutate_tracked(
    seq: np.ndarray, rate: float, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``mutate``, with where each output letter came from: its position
    in ``seq`` or, for an inserted letter (``inserted`` True), the
    position it was inserted before."""
    out = seq.copy()
    codes = np.searchsorted(_BASES, out)  # A C G T -> 0..3
    mut = rng.random(out.size) < rate
    codes[mut] = (codes[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    out[mut] = _BASES[codes[mut]]
    n_indels = int(out.size * rate / 20)
    pieces, origin, inserted = [], [], []
    start = 0
    for pos in np.sort(rng.choice(out.size, n_indels, replace=False)):
        pieces.append(out[start:pos])
        origin.append(np.arange(start, pos))  # empty where start > pos
        inserted.append(np.zeros(pieces[-1].size, dtype=bool))
        size = int(rng.integers(1, 6))
        if rng.random() < 0.5:  # insertion
            pieces.append(_BASES[rng.integers(0, 4, size)])
            origin.append(np.full(size, pos))
            inserted.append(np.ones(size, dtype=bool))
            start = pos
        else:  # deletion
            start = min(out.size, pos + size)
    pieces.append(out[start:])
    origin.append(np.arange(start, out.size))
    inserted.append(np.zeros(pieces[-1].size, dtype=bool))
    return np.concatenate(pieces), np.concatenate(origin), np.concatenate(inserted)


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
    return [genome for genome, _origin, _inserted in _related_tracked(length, rates, seed)]


def _related_tracked(length: int, rates: list[float], seed: int):
    """``related_genomes`` with each genome's ``_mutate_tracked`` origins."""
    rng = np.random.default_rng(seed)
    ancestor = _BASES[rng.integers(0, 4, length)]
    genomes = []
    for rate in rates:
        if rate:
            genome, origin, inserted = _mutate_tracked(ancestor, rate, rng)
        else:
            genome = ancestor.copy()
            origin, inserted = np.arange(length), np.zeros(length, dtype=bool)
        salt(genome, rng)
        genomes.append((genome, origin, inserted))
    return genomes


def _fasta_record(header: str, seq: np.ndarray, width: int = 80) -> bytes:
    raw = seq.tobytes()
    lines = [header.encode(), *(raw[i : i + width] for i in range(0, len(raw), width))]
    return b"\n".join(lines) + b"\n"


def write_fasta(path: Path, name: str, seq: np.ndarray, width: int = 80) -> Path:
    path.write_bytes(_fasta_record(f">{name} synthetic", seq, width))
    return path


def write_multi_fasta(path: Path, records: list[tuple[str, np.ndarray]], width: int = 80) -> Path:
    """Several records, each (name, ASCII sequence), in one FASTA file."""
    path.write_bytes(b"".join(_fasta_record(f">{name} synthetic", seq, width) for name, seq in records))
    return path


def random_sequence(length: int, rng: np.random.Generator) -> np.ndarray:
    """`length` uniform random bases: unrelated to any other sequence."""
    return _BASES[rng.integers(0, 4, length)]


# The reference's coverage set: two contigs of one assembly (MIBY01000005,
# 7,582 bp with a 28-N run; MIBY01000011, 18,001 bp), each alone and both
# in one file. These stand in for them: random contigs of the same lengths.
COVERAGE_CONTIGS = {"small": 7582, "large": 18001}
# (offset, length) of the small contig's N run: inside ANIb's fourth
# 1,020 bp fragment (3,060-4,079), whose alignment crosses it, as the
# reference's does, so that the fragment keeps its full coverage.
COVERAGE_N_RUN = (3550, 28)


def write_coverage_set(directory: Path, seed: int) -> list[Path]:
    """small.fasta (7,582 bp with a 28-N run), large.fasta (18,001 bp) and
    both.fasta (the two records in one file) in `directory`."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    contigs = {name: random_sequence(length, rng) for name, length in COVERAGE_CONTIGS.items()}
    offset, run = COVERAGE_N_RUN
    contigs["small"][offset : offset + run] = ord("N")
    return [
        write_multi_fasta(directory / "small.fasta", [("small_contig", contigs["small"])]),
        write_multi_fasta(directory / "large.fasta", [("large_contig", contigs["large"])]),
        write_multi_fasta(directory / "both.fasta", [(f"{name}_contig", seq) for name, seq in contigs.items()]),
    ]


# The stems of the reference's bad_alignments pair: two phage genomes that
# share no homology.
NULL_PAIR_STEMS = ("MGV-GENOME-0264574", "MGV-GENOME-0357962")


def write_null_pair(directory: Path, length: int, seed: int) -> list[Path]:
    """Two unrelated random genomes of `length` bp, named by the
    bad_alignments stems: every cross comparison is NULL."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    return [write_fasta(directory / f"{stem}.fna", stem, random_sequence(length, rng)) for stem in NULL_PAIR_STEMS]


def write_n_run_genome(path: Path, length: int, seed: int) -> Path:
    """One random genome of `length` bp with a run of 28 Ns in its middle,
    as in the coverage set's small contig."""
    run = COVERAGE_N_RUN[1]
    seq = random_sequence(length, np.random.default_rng(seed))
    seq[(length - run) // 2 : (length + run) // 2] = ord("N")
    return write_fasta(path, path.stem, seq)


# A divergent pair of two-contig genomes: alignment blocks that end short
# of a contig's end leave tails for the free-end extension.
CONTIG_PAIR_LENGTHS = [4000, 2500]
CONTIG_PAIR_RATE = 0.05


def write_contig_pair(directory: Path, seed: int) -> list[Path]:
    """contigs.fna (two random contigs) and contigs_mutated.fna (each
    contig ``mutate``d at 5%) in `directory`."""
    directory.mkdir(parents=True, exist_ok=True)
    return [
        write_contigs_genome(directory / "contigs.fna", CONTIG_PAIR_LENGTHS, seed),
        write_contigs_genome(directory / "contigs_mutated.fna", CONTIG_PAIR_LENGTHS, seed, CONTIG_PAIR_RATE),
    ]


def write_contigs_genome(path: Path, lengths: list[int], seed: int, rate: float = 0.0) -> Path:
    """One genome of unrelated random contigs of `lengths` bp, one record
    each; at `rate` > 0 each contig is a ``mutate``d copy of the contig
    that the same seed gives at rate 0."""
    rng = np.random.default_rng(seed)
    contigs = [random_sequence(n, rng) for n in lengths]
    if rate:
        contigs = [mutate(contig, rate, rng) for contig in contigs]
    return write_multi_fasta(path, [(f"{path.stem}_{i}", seq) for i, seq in enumerate(contigs)])


def write_rotated_pair(directory: Path, length: int, rate: float, seed: int) -> list[Path]:
    """genome.fna (random, `length` bp) and rotated.fna (a ``mutate``d
    copy at `rate`, rotated by a third of its length) in `directory`: a
    circular genome read from two origins, aligned in two blocks that
    meet at the rotation point."""
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = random_sequence(length, rng)
    copy = mutate(genome, rate, rng)
    return [
        write_fasta(directory / "genome.fna", "genome", genome),
        write_fasta(directory / "rotated.fna", "rotated", np.roll(copy, length // 3)),
    ]


def write_genome_dir(
    directory: Path, length: int, rates: list[float], seed: int
) -> list[Path]:
    """FASTA files genome_0.fna, genome_1.fna, ... in `directory`."""
    directory.mkdir(parents=True, exist_ok=True)
    return [
        write_fasta(directory / f"genome_{idx}.fna", f"genome_{idx}", seq)
        for idx, seq in enumerate(related_genomes(length, rates, seed))
    ]


def write_alignment(
    directory: Path, length: int, rates: list[float], seed: int,
    name: str = "genomes.aln",
) -> tuple[list[Path], Path]:
    """The genomes of ``write_genome_dir`` and their true multiple
    alignment, a FASTA file ``directory/name`` (the extension keeps it out
    of the genome set) with one row a genome, named by its file's stem.

    Columns follow the ancestor; a letter deleted from a genome is a gap
    in its row, and each inserted letter has a column of its own that is
    a gap in every other row. Columns that are gaps in every row are left
    out."""
    paths = write_genome_dir(directory, length, rates, seed)
    tracked = _related_tracked(length, rates, seed)
    # a letter's column key: its ancestor position, inserted letters
    # first, then (for inserted letters only) genome and offset
    keys = [
        np.stack([origin, ~inserted, np.where(inserted, idx, -1),
                  np.where(inserted, np.arange(genome.size), -1)], axis=1)
        for idx, (genome, origin, inserted) in enumerate(tracked)
    ]  # fmt: skip
    stacked = np.concatenate(keys)
    order = np.lexsort(stacked.T[::-1])
    ordered = stacked[order]
    new = np.ones(order.size, dtype=bool)
    new[1:] = (ordered[1:] != ordered[:-1]).any(axis=1)
    where = np.empty(order.size, dtype=np.int64)
    where[order] = np.cumsum(new) - 1  # each letter's column
    rows, offset = [], 0
    for genome, _origin, _inserted in tracked:
        row = np.full(int(new.sum()), ord("-"), dtype=np.uint8)
        row[where[offset : offset + genome.size]] = genome
        offset += genome.size
        rows.append(row)
    alignment = directory / name
    alignment.write_bytes(b"".join(_fasta_record(f">{p.stem}", row) for p, row in zip(paths, rows)))
    return paths, alignment


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


# The JAX package's unit edge inputs, drawn as its unit tests draw them
# (tests/test_dp.py, test_native.py, test_anib.py and
# test_tiles_minhash_edges.py), for the port's unit tests and the card
# smoke run's unit-edge phase. A task is (a, b) of uint8 codes.

_DP_FLANK = b"ACGTACGTACGTACGTACGT"
DP_PAIRS = {  # tests/test_dp.py's named inputs, as letters
    "exact": (_DP_FLANK, _DP_FLANK),
    "one_mismatch": (_DP_FLANK, b"ACGTACGTTCGTACGTACGT"),
    "gap": (_DP_FLANK, b"ACGTACGTGTACGTACGT"),  # a 2 bp deletion
    "n_run": (b"ACGTNNNNACGT", b"ACGTNNNNACGT"),
    "no_alignment": (b"AAAA", b"TTTT"),
    "iupac_same": (_DP_FLANK + b"WW" + _DP_FLANK, _DP_FLANK + b"WW" + _DP_FLANK),
    "iupac_diff": (_DP_FLANK + b"WW" + _DP_FLANK, _DP_FLANK + b"RK" + _DP_FLANK),
}
# The JAX package's largest extension bucket (extend_pallas.M_COLS_BUCKETS[-1]):
# its Pallas kernel sends a longer task to the host kernel; the port's
# kernel takes any length.
EXTEND_BUCKET_LIMIT = 10_240
IUPAC_LETTERS = np.frombuffer(b"ACGTNRYSWKMBDHV", dtype=np.uint8)


def dp_pairs() -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """``DP_PAIRS`` encoded."""
    from pyani_plus_tpu_torch.genomes import encode_sequence

    return {name: (encode_sequence(a), encode_sequence(b)) for name, (a, b) in DP_PAIRS.items()}


def extension_fuzz_tasks(seed: int, count: int, max_len: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """tests/test_dp.py's extension fuzz: codes 0-4 in a, homology at 10%
    substitutions in about 60% of the tasks, uneven lengths from 60."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        m = int(rng.integers(60, max_len))
        n = int(rng.integers(60, max_len))
        a = rng.integers(0, 5, m).astype(np.uint8)
        b = rng.integers(0, 4, n).astype(np.uint8)
        if rng.random() < 0.6:
            span = min(m, n)
            b[:span] = a[:span] % 4
            mut = rng.random(span) < 0.1
            b[:span][mut] = (b[:span][mut] + 1) % 4
        tasks.append((a, b))
    return tasks


def extension_tasks(rng: np.random.Generator, lanes: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """B1's main shape: 1,500-3,200 rows, every 8th task 9,900, at 12%
    substitutions (the draws of the root bench.py's extension section)."""
    tasks = []
    for i in range(lanes):
        m = int(rng.integers(1500, 3200)) if i % 8 else 9900
        a = rng.integers(0, 4, m).astype(np.uint8)
        tasks.append((a, substitute(a, 0.12, rng)))
    return tasks


def extension_oversize_tasks() -> list[tuple[np.ndarray, np.ndarray]]:
    """tests/test_dp.py's four tasks around the largest bucket: the first
    and third longer than ``EXTEND_BUCKET_LIMIT``, 5% substitutions."""
    rng = np.random.default_rng(7)
    big = EXTEND_BUCKET_LIMIT + 64
    tasks = []
    for m, n in ((big, 400), (300, 280), (big + 32, big), (256, 300)):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a[: min(m, n)].copy()
        mut = rng.random(b.size) < 0.05
        b[mut] = (b[mut] + 1) % 4
        tasks.append((a, b[:n] if n <= b.size else b))
    return tasks


def band_dp_trials(seed: int = 12, count: int = 30) -> list[tuple[np.ndarray, np.ndarray, int]]:
    """tests/test_native.py's band DP fuzz: (a, b, band) with 1-119 codes
    each, b a prefix of a half the time, Ns sprinkled in a, bands 1-19."""
    rng = np.random.default_rng(seed)
    trials = []
    for _ in range(count):
        m = int(rng.integers(1, 120))
        n = int(rng.integers(1, 120))
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a[:n].copy() if rng.random() < 0.5 and n <= m else rng.integers(0, 4, n).astype(np.uint8)
        a[rng.random(m) < 0.05] = 4
        trials.append((a, b, int(rng.integers(1, 20))))
    return trials


def extension_end_gap_tasks(seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Tails whose alignment opens or closes with a gap, as at the ends of
    dnadiff's blocks: 1, 3, 10 and 61 extra codes (the last past the
    band) before or after a shared 300-code core, in a or in b."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    tasks = []
    for k in (1, 3, 10, 61):
        extra = rng.integers(0, 4, k).astype(np.uint8)
        head, tail = np.concatenate([extra, core]), np.concatenate([core, extra])
        tasks += [(head, core), (core, head), (tail, core), (core, tail)]
    return tasks


def extension_edge_tasks(seed: int) -> dict[str, list[tuple[np.ndarray, np.ndarray]]]:
    """Every unit edge input of the free-end extension, by group:
    ``dp`` (``DP_PAIRS``, one-code tasks, N-only and IUPAC tasks),
    ``fuzz`` (tests/test_dp.py's two fuzz sets), ``oversize``,
    ``band`` (``band_dp_trials`` as band-60 tasks) and ``end_gaps``."""
    from pyani_plus_tpu_torch.genomes import encode_sequence

    rng = np.random.default_rng(seed)
    one = [encode_sequence(x) for x in (b"A", b"C", b"N", b"W")]
    dp = list(dp_pairs().values()) + [(x, y) for x in one for y in one]
    dp += [(np.full(50, 4, np.uint8), np.full(50, 4, np.uint8)),  # N only
           (np.full(40, 4, np.uint8), rng.integers(0, 4, 40).astype(np.uint8))]
    for _ in range(6):  # IUPAC letters in both, a tenth of them changed in b
        letters = IUPAC_LETTERS[rng.integers(0, 15, int(rng.integers(20, 200)))]
        changed = letters.copy()
        swap = rng.random(letters.size) < 0.1
        changed[swap] = IUPAC_LETTERS[rng.integers(0, 15, int(swap.sum()))]
        dp.append((encode_sequence(letters.tobytes()), encode_sequence(changed.tobytes())))
    return {
        "dp": dp,
        "fuzz": extension_fuzz_tasks(23, 24, 1200) + extension_fuzz_tasks(41, 20, 1100),
        "oversize": extension_oversize_tasks(),
        "band": [(a, b) for a, b, _band in band_dp_trials()],
        "end_gaps": extension_end_gap_tasks(seed + 1),
    }


SW_PAD_CODE = 5  # the JAX kernels' padding code: never matches anything
SW_PACKED_ROWS = 16_360  # ops/sw.uses_packed_lanes: packed 16-bit lanes up to min(m, n) = 16,360


def _sw_homolog(q: np.ndarray, width: int, rng: np.random.Generator) -> np.ndarray:
    """A window of `width` codes holding `q` at 5% substitutions in its
    middle, random codes around it."""
    s = rng.integers(0, 4, width).astype(np.uint8)
    start = (width - q.size) // 2
    copy = q.copy()
    mut = rng.random(q.size) < 0.05
    copy[mut] = (copy[mut] + 1) % 4
    s[start : start + q.size] = copy
    return s


def sw_score_parity_tasks() -> list[tuple[np.ndarray, np.ndarray]]:
    """tests/test_dp.py's score parity set: 6 queries of 60 codes in
    subjects of 90, every other one holding its query at 10% from 5."""
    rng = np.random.default_rng(11)
    qs = rng.integers(0, 4, (6, 60)).astype(np.uint8)
    ss = rng.integers(0, 4, (6, 90)).astype(np.uint8)
    for i in range(0, 6, 2):
        ss[i, 5:65] = qs[i]
        mut = rng.random(60) < 0.1
        ss[i, 5:65][mut] = (ss[i, 5:65][mut] + 1) % 4
    return list(zip(qs, ss))


def sw_iupac_fuzz_tasks() -> list[tuple[np.ndarray, np.ndarray]]:
    """tests/test_dp.py's IUPAC fuzz: 25 pairs of random letters from the
    whole IUPAC alphabet."""
    from pyani_plus_tpu_torch.genomes import encode_sequence

    rng = np.random.default_rng(42)
    tasks = []
    for _ in range(25):
        m = int(rng.integers(10, 120))
        n = int(rng.integers(10, 160))
        q = encode_sequence(IUPAC_LETTERS[rng.integers(0, 15, m)].tobytes())
        s = encode_sequence(IUPAC_LETTERS[rng.integers(0, 15, n)].tobytes())
        tasks.append((q, s))
    return tasks


def sw_trim_fuzz_tasks(seed: int = 7, count: int = 24) -> list[tuple[np.ndarray, np.ndarray]]:
    """tests/test_dp.py's trim-equivalence fuzz (at its seed and count by
    default): homology planted in about 70% of the tasks, unpadded."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        m = int(rng.integers(20, 90))
        n = int(rng.integers(30, 140))
        q = rng.integers(0, 5, m).astype(np.uint8)
        s = rng.integers(0, 5, n).astype(np.uint8)
        if rng.random() < 0.7:
            ln = min(m, n) // 2
            s[:ln] = q[:ln]
        tasks.append((q, s))
    return tasks


def sw_padded(tasks: list[tuple[np.ndarray, np.ndarray]]) -> list[tuple[np.ndarray, np.ndarray]]:
    """The tasks as rows of one batch padded with ``SW_PAD_CODE`` to the
    longest query and subject, as the JAX package's batch kernels take
    them."""
    m = max(q.size for q, _ in tasks)
    n = max(s.size for _, s in tasks)
    return [
        (np.concatenate([q, np.full(m - q.size, SW_PAD_CODE, np.uint8)]),
         np.concatenate([s, np.full(n - s.size, SW_PAD_CODE, np.uint8)]))
        for q, s in tasks
    ]  # fmt: skip


def sw_pallas_tasks(seed: int = 5, count: int = 24) -> list[tuple[np.ndarray, np.ndarray]]:
    """tests/test_anib.py's Pallas SW set (at its seed and count by
    default): m <= 128, n <= 256, N codes in two of three tasks and
    padding codes beside them, a mutated copy in every fourth."""
    rng = np.random.default_rng(seed)
    tasks = []
    for trial in range(count):
        m = int(rng.integers(1, 129))
        n = int(rng.integers(1, 257))
        hi = 5 if trial % 3 else 4
        q = rng.integers(0, hi, m).astype(np.uint8)
        s = rng.integers(0, hi, n).astype(np.uint8)
        if trial % 4 == 0 and n > m:
            s[:m] = q
            mut = rng.random(m) < 0.2
            s[:m][mut] = (s[:m][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        tasks.append((q, s))
    return tasks


# tests/test_anib.py's genome: 39,253 bp, 39 fragments of 1,020, the last
# one a tail of 493
FRAGMENT_GENOME_LENGTH = 39_253


def sw_fragment_tasks(seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """ANIb's fragments at the edges: the tail fragment of a
    ``FRAGMENT_GENOME_LENGTH`` genome in a window 300 columns wider, a
    1,020-code fragment of N only, one of the padding code only, and a
    1,020-code fragment in a window as wide as the width rule's edge."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, FRAGMENT_GENOME_LENGTH).astype(np.uint8)
    tail = genome[(FRAGMENT_GENOME_LENGTH // 1020) * 1020 :]
    frag = genome[:1020]
    return [
        (tail, _sw_homolog(tail, tail.size + 300, rng)),
        (np.full(1020, 4, np.uint8), _sw_homolog(frag, 1320, rng)),
        (np.full(1020, SW_PAD_CODE, np.uint8), _sw_homolog(frag, 1320, rng)),
        (frag, _sw_homolog(frag, SW_PACKED_ROWS, rng)),
    ]


def sw_rule_edge_tasks(seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """A fragment of ``SW_PACKED_ROWS`` codes and one of a code more, each
    in a window as wide: the last task of the packed 16-bit lanes and the
    first of the 32-bit words (about 270 M cells each)."""
    rng = np.random.default_rng(seed)
    tasks = []
    for m in (SW_PACKED_ROWS, SW_PACKED_ROWS + 1):
        q = rng.integers(0, 4, m).astype(np.uint8)
        tasks.append((q, _sw_homolog(q, m, rng)))
    return tasks


def sw_edge_tasks(seed: int, *, rule_edge: bool) -> dict[str, list[tuple[np.ndarray, np.ndarray]]]:
    """Every unit edge input of the Smith-Waterman, by group; the width
    rule's two large tasks only with `rule_edge`."""
    groups = {
        "dp": list(dp_pairs().values()),
        "score_parity": sw_score_parity_tasks(),
        "iupac": sw_iupac_fuzz_tasks(),
        "trim": sw_trim_fuzz_tasks(),
        "trim_padded": sw_padded(sw_trim_fuzz_tasks()),
        "pallas": sw_pallas_tasks(),
        "fragments": sw_fragment_tasks(seed),
    }
    if rule_edge:
        groups["rule_edge"] = sw_rule_edge_tasks(seed + 1)
    return groups


def gram_edge_sets() -> dict[str, list[Sketch]]:
    """tests/test_tiles_minhash_edges.py's sketches (k = 31, scaled =
    1,000): two identical sketches, two disjoint ones, a sketch and its
    half, and an empty sketch beside a full one."""

    def sketch(hashes) -> Sketch:
        return Sketch("x", 31, 1000, np.asarray(sorted(hashes), dtype=np.uint64))

    full = sketch(range(100))
    return {
        "identical": [full, full],
        "disjoint": [full, sketch(range(1000, 1100))],
        "subset": [sketch(range(200)), full],
        "empty": [sketch([]), sketch(range(50))],
    }
