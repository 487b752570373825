"""The port's FracMinHash device code against the JAX package, on the CPU.

- The membership Gram (``intersection_matrix_device``) on sketch sets that
  stress exactness (per-block counts past 256, 2,048 and up to 4,096,
  empty sketches, hashes of 2^63 and above) equals the host Gram (scipy)
  and the JAX package's XLA Gram (``mesh=None``), exactly.
- ``containment_ani`` equals the JAX package's, floats ``==`` and NaN in
  the same places, on either Gram, and routes at the same threshold.
- The device sketch equals the host sketch (``sketch_genome``, native)
  and the JAX device sketch bit for bit, for k of 21, 31 and 32.
- The sourmash method's rows equal the JAX package's with the device Gram.

Sketches and genomes come from numpy seeds; both packages take the same
``Sketch`` objects.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import pytest
import torch

import pyani_plus_tpu.methods.sourmash as jax_sourmash
import pyani_plus_tpu.ops.minhash as jax_minhash
from pyani_plus_tpu.genomes import Genome, SequenceRecord, load_genome
from pyani_plus_tpu.ops.minhash import Sketch, intersection_matrix_host, sketch_genome
from pyani_plus_tpu_torch import methods
from pyani_plus_tpu_torch.methods import sourmash
from pyani_plus_tpu_torch.ops import minhash
from pyani_plus_tpu_torch.synthetic import clade_sketches, gram_fuzz_sets, write_clade_dir

FUZZ = gram_fuzz_sets(seed=3, n=12)


@pytest.mark.parametrize("block", [4096, 128])
@pytest.mark.parametrize("name", sorted(FUZZ))
def test_gram_matches_host_and_jax(name: str, block: int) -> None:
    sketches = FUZZ[name]
    before = minhash.LAUNCHES
    got = minhash.intersection_matrix_device(sketches, block=block)
    assert got.dtype == np.int64
    assert np.array_equal(got, intersection_matrix_host(sketches))
    expected = jax_minhash.intersection_matrix_device(sketches, block=block, mesh=None)
    assert np.array_equal(got, expected)
    assert minhash.LAUNCHES == before  # counts calls on CUDA only


def test_fuzz_sets_reach_the_exactness_edges() -> None:
    """Per-block counts above 256 and 2,048 (odd ones too) and of 4,096,
    and hashes of 2^63 and above, are in the sets the Gram is held to."""
    core = FUZZ["core"]
    n = len(core)
    pts = minhash.incidence(core, 4096)
    per_block = [
        minhash.gram(torch.from_numpy(pts[b : b + 1]), n, 4096)
        for b in range(pts.shape[0])
    ]
    assert max(int(c.max()) for c in per_block) == 4096
    assert any(((c % 2 == 1) & (c > 2048)).any() for c in per_block)
    pool = minhash.intersection_matrix_device(FUZZ["pool"])
    assert 256 < pool[~np.eye(len(FUZZ["pool"]), dtype=bool)].min()
    assert any((s.hashes >= np.uint64(1 << 63)).any() for s in FUZZ["high"])
    assert any(s.num_hashes == 0 for s in FUZZ["empty"])


def test_gram_counts_past_float32_accumulation() -> None:
    """The blocks add up in float64: one sketch holding every id of 17
    blocks of 2^20 but one, an odd count above 2^24, counts exactly (a
    float32 accumulator would round it)."""
    block = 1 << 20
    pts = np.tile(np.arange(block, dtype=np.int32), (17, 1))
    pts[-1, -1] = block  # the pad slot
    counts = minhash.gram(torch.from_numpy(pts), 1, block)
    assert int(counts[0, 0]) == 17 * block - 1


def test_gram_rejects_blocks_past_float32() -> None:
    with pytest.raises(ValueError, match="block"):
        minhash.intersection_matrix_device(FUZZ["pool"], block=1 << 24)


@pytest.mark.parametrize("use_device", [True, False, None])
@pytest.mark.parametrize("name", ["pool", "empty", "high", "clades"])
def test_containment_ani_matches_jax(name: str, use_device: bool | None) -> None:
    sketches = clade_sketches(5, 70, 4, core=800, sizes=(900, 1200)) if name == "clades" else FUZZ[name]
    got = minhash.containment_ani(sketches, use_device=use_device)
    expected = jax_minhash.containment_ani(sketches, use_device=use_device, mesh=None)
    for g, e in zip(got, expected):
        assert np.array_equal(g, e, equal_nan=True)  # floats ==, NaN in the same places
    identity = got[0]
    nonempty = np.array([s.num_hashes > 0 for s in sketches])
    assert (np.diag(identity)[nonempty] == 1.0).all()
    assert np.isnan(np.diag(identity)[~nonempty]).all()


def _sized_sketches(n: int, total: int) -> list[Sketch]:
    sizes = np.full(n, total // n)
    sizes[: total % n] += 1
    starts = np.concatenate(([0], np.cumsum(sizes)))
    return [
        Sketch(f"s{i}", 31, 1000, np.arange(starts[i], starts[i + 1], dtype=np.uint64))
        for i in range(n)
    ]


@pytest.mark.parametrize(
    ("n", "total", "route"),
    [(63, (1 << 18) + 1, "host"), (64, 1 << 18, "host"), (64, (1 << 18) + 1, "device"),
     (65, 1 << 19, "device")],
)  # fmt: skip
def test_threshold_routes_as_jax(monkeypatch, n: int, total: int, route: str) -> None:
    sketches = _sized_sketches(n, total)
    assert sum(s.num_hashes for s in sketches) == total
    routes: dict[str, list[str]] = {"port": [], "jax": []}

    def fake(tag, kind):
        def counts(sk, **_):
            routes[tag].append(kind)
            return np.zeros((len(sk), len(sk)), dtype=np.int64)

        return counts

    for tag, module in (("port", minhash), ("jax", jax_minhash)):
        monkeypatch.setattr(module, "intersection_matrix_device", fake(tag, "device"))
        monkeypatch.setattr(module, "intersection_matrix_host", fake(tag, "host"))
    minhash.containment_ani(sketches)
    jax_minhash.containment_ani(sketches)
    assert routes == {"port": [route], "jax": [route]}


def _genomes() -> list[Genome]:
    """tests/test_minhash.py's multi-record genomes with N runs, plus
    IUPAC letters, a record shorter than k and a genome of N only."""
    rng = np.random.default_rng(31)
    genomes = []
    for gi in range(5):
        recs = []
        for ri in range(1 + gi % 3):
            n = int(rng.integers(200, 40_000))
            codes = rng.integers(0, 4, n, dtype=np.uint8)
            codes[rng.random(n) < 0.002] = 4  # N runs
            recs.append(SequenceRecord(title=f"r{ri}".encode(), codes=codes))
        genomes.append(Genome(md5=f"g{gi}", path=None, records=recs))
    codes = rng.integers(0, 4, 9000, dtype=np.uint8)
    codes[rng.random(codes.size) < 0.001] = ord("R")  # an IUPAC letter
    short = rng.integers(0, 4, 20, dtype=np.uint8)
    genomes.append(
        Genome(md5="g5", path=None, records=[SequenceRecord(b"iupac", codes), SequenceRecord(b"short", short)])
    )
    genomes.append(Genome(md5="g6", path=None, records=[SequenceRecord(b"n", np.full(500, 4, np.uint8))]))
    return genomes


GENOMES = _genomes()


@pytest.mark.parametrize("scaled", [1, 40, 1000])
@pytest.mark.parametrize("k", [21, 31, 32])
def test_device_sketch_matches_host_and_jax(k: int, scaled: int) -> None:
    got = minhash.sketch_genomes_device(GENOMES, k, scaled, chunk_w=1 << 13, batch=3)
    jax_dev = jax_minhash.sketch_genomes_device(GENOMES, k, scaled, chunk_w=1 << 13, batch=3)
    for genome, sketch, other in zip(GENOMES, got, jax_dev, strict=True):
        host = sketch_genome(genome, k, scaled)
        assert (sketch.md5, sketch.ksize, sketch.scaled) == (genome.md5, k, scaled)
        assert sketch.hashes.dtype == np.uint64
        assert np.array_equal(sketch.hashes, host.hashes), genome.md5
        assert np.array_equal(other.hashes, host.hashes), genome.md5  # the reference agrees
    assert got[-1].num_hashes == 0
    if scaled == 1:
        assert any((s.hashes >= np.uint64(1 << 63)).any() for s in got)


def test_device_sketch_single_genome_and_k_limit() -> None:
    one = minhash.sketch_genome_device(GENOMES[1], 31, 40, chunk_w=1 << 12, batch=2)
    assert np.array_equal(one.hashes, sketch_genome(GENOMES[1], 31, 40).hashes)
    with pytest.raises(ValueError, match="k=33"):
        minhash.sketch_genomes_device(GENOMES[:1], 33, 1000)


def _context(genomes: list) -> methods.ComputeContext:
    run = {g.md5: g for g in genomes}
    return methods.ComputeContext(
        logger=logging.getLogger(__name__),
        genomes=run,
        query_hashes=list(run),
        subject_hashes=list(run),
        pending={(q, s) for q in run for s in run},
        config={"kmersize": 21, "extra": "scaled=100"},
    )


def test_clade_dir_and_sourmash_rows_match_jax(monkeypatch, tmp_path) -> None:
    """Clades written to one directory share hashes inside a clade and
    none across; the port's sourmash rows, with the device Gram forced,
    equal the JAX package's."""
    paths = write_clade_dir(tmp_path / "clades", 20_000, 3, [0.005, 0.03], seed=9)
    assert sorted(p.name for p in paths) == sorted(
        f"clade_{c}_genome_{i}.fna" for c in range(3) for i in range(2)
    )
    genomes = [load_genome(p) for p in paths]
    assert len({g.md5 for g in genomes}) == 6
    monkeypatch.setattr(
        sourmash, "containment_ani", functools.partial(minhash.containment_ani, use_device=True)
    )
    key = lambda r: (r["query_hash"], r["subject_hash"])  # noqa: E731
    rows = sorted(sourmash.compute(_context(genomes)), key=key)
    assert rows == sorted(jax_sourmash.compute(_context(genomes)), key=key)
    clade = {g.md5: p.name.split("_genome")[0] for g, p in zip(genomes, paths)}
    for row in rows:
        q, s = key(row)
        assert (row["identity"] is None) == (clade[q] != clade[s]), row
        if q == s:
            assert row["identity"] == 1.0


@pytest.mark.gpu
def test_gram_and_sketch_on_the_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, sketches in gram_fuzz_sets(seed=4, n=70).items():
        before = minhash.LAUNCHES
        got = minhash.intersection_matrix_device(sketches)
        assert np.array_equal(got, minhash.intersection_matrix_device(sketches, device="cpu")), name
        assert np.array_equal(got, intersection_matrix_host(sketches)), name
        assert minhash.LAUNCHES == before + any(s.num_hashes for s in sketches)
    for k in (21, 31, 32):
        for scaled in (1, 1000):
            got = minhash.sketch_genomes_device(GENOMES, k, scaled, chunk_w=1 << 13, batch=3)
            for genome, sketch in zip(GENOMES, got):
                assert np.array_equal(sketch.hashes, sketch_genome(genome, k, scaled).hashes)
