"""The port's own copies of the host modules against the JAX package's.

The port keeps a copy of every numpy and C++ host module it uses
(``native/``, ``ops/chaining|dp|suffix|seeds|kmers|extend_host``,
``genomes``, ``utils``, ``db``, ``report``) under the JAX package's
module names. Each copy is driven here on inputs made with numpy from a
seed and must give what the original gives: arrays equal element for
element, tuples and dataclass fields equal, files byte for byte.

Whether the native libraries exist is decided inside the ``libraries``
fixture, never while this module is imported.
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
from pathlib import Path

import numpy as np
import pytest

import pyani_plus_tpu.db as jax_db
import pyani_plus_tpu.genomes as jax_genomes
import pyani_plus_tpu.methods.anib as jax_anib
import pyani_plus_tpu.methods.anim as jax_anim
import pyani_plus_tpu.methods.dnadiff as jax_dnadiff
import pyani_plus_tpu.native as jax_native
import pyani_plus_tpu.ops.chaining as jax_chaining
import pyani_plus_tpu.ops.dp as jax_dp
import pyani_plus_tpu.ops.extend as jax_extend
import pyani_plus_tpu.ops.kmers as jax_kmers
import pyani_plus_tpu.ops.minhash as jax_minhash
import pyani_plus_tpu.ops.seeds as jax_seeds
import pyani_plus_tpu.ops.suffix as jax_suffix
import pyani_plus_tpu.report.classify as jax_classify
import pyani_plus_tpu.report.export as jax_export
import pyani_plus_tpu.utils as jax_utils
import pyani_plus_tpu_torch.db as port_db
import pyani_plus_tpu_torch.genomes as port_genomes
import pyani_plus_tpu_torch.methods.anib as port_anib
import pyani_plus_tpu_torch.methods.anim as port_anim
import pyani_plus_tpu_torch.methods.dnadiff as port_dnadiff
import pyani_plus_tpu_torch.native as port_native
import pyani_plus_tpu_torch.ops.chaining as port_chaining
import pyani_plus_tpu_torch.ops.dp as port_dp
import pyani_plus_tpu_torch.ops.extend_host as port_extend
import pyani_plus_tpu_torch.ops.kmers as port_kmers
import pyani_plus_tpu_torch.ops.minhash as port_minhash
import pyani_plus_tpu_torch.ops.seeds as port_seeds
import pyani_plus_tpu_torch.ops.suffix as port_suffix
import pyani_plus_tpu_torch.report.classify as port_classify
import pyani_plus_tpu_torch.report.export as port_export
import pyani_plus_tpu_torch.utils as port_utils
from pyani_plus_tpu_torch.ops import _build
from pyani_plus_tpu_torch.parallel.tiles import owned_pairs
from pyani_plus_tpu_torch.synthetic import write_genome_dir

BLAST = (2, -3, 5, 2)  # reward, penalty, gap open, gap extend
NUCMER = (3, -7, -13, -7)  # match, mismatch, gap open, gap extend


@pytest.fixture(scope="module")
def libraries() -> None:
    """Both packages' native libraries, built here if need be."""
    if not (jax_native.have_native() and port_native.have_native()):
        pytest.skip("no C++ compiler: the native libraries cannot be built")


def related(rng: np.random.Generator, length: int, rate: float, *, n_codes: int = 4):
    """Two code arrays: a random one and a copy with substitutions and a
    few short indels."""
    a = rng.integers(0, n_codes, length).astype(np.uint8)
    b = a.copy()
    mut = rng.random(length) < rate
    b[mut] = (b[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    for pos in sorted(rng.integers(10, length - 10, 3), reverse=True):
        if rng.random() < 0.5:
            b = np.delete(b, slice(pos, pos + int(rng.integers(1, 4))))
        else:
            b = np.insert(b, pos, rng.integers(0, 4, int(rng.integers(1, 4))))
    return a, b.astype(np.uint8)


def same(x, y) -> None:
    """Deep equality of arrays, tuples, lists, dataclasses and scalars."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    elif isinstance(x, (tuple, list)):
        assert type(x) is type(y) and len(x) == len(y)
        for u, v in zip(x, y):
            same(u, v)
    elif dataclasses.is_dataclass(x):
        assert type(x).__name__ == type(y).__name__
        same(dataclasses.astuple(x), dataclasses.astuple(y))
    else:
        assert x == y and type(x) is type(y)


# ---------------------------------------------------------------- native


def _suffix_array(native, rng):
    text = rng.integers(0, 5, 3000).astype(np.int64)
    sa = native.suffix_array_native(text)
    return sa, native.kasai_lcp_native(text, sa)


def _suffix_automaton(native, rng):
    ref, qry = related(rng, 4000, 0.05)
    index = native.sam_build_native(ref)
    return (
        index.n,
        index.states,
        native.sam_stream_ms_native(index, qry),
        native.sam_stream_maxmatch_native(index, qry, 12),
    )


def _chain(native, rng):
    n = 400
    r = np.sort(rng.integers(0, 50_000, n)).astype(np.int64)
    q = (r + rng.integers(-40, 40, n)).astype(np.int64)
    length = rng.integers(20, 90, n).astype(np.int64)
    order = np.argsort(r + length, kind="stable").astype(np.int64)
    return (
        native.cluster_roots_native(r, q, length, 90, 5, 0.12),
        native.chain_dp_native(r, r + length, length.astype(np.float64), order),
        native.anchor_chain_dp_native(r, q, length),
    )


def _band(native, rng):
    out = []
    for length, rate, codes in ((700, 0.08, 4), (1500, 0.15, 5), (90, 0.3, 4)):
        a, b = related(rng, length, rate, n_codes=codes)
        out.append(native.band_dp_native(a, b, 60, True, *NUCMER, 600))
        gap_band = abs(a.size - b.size) + 20
        out.append(native.band_dp_native(a, b, gap_band, False, *NUCMER))
    return out


def _align(native, rng):
    out = []
    for length, rate in ((300, 0.05), (1020, 0.12), (60, 0.4)):
        q, s = related(rng, length, rate, n_codes=5)
        s = np.concatenate([rng.integers(0, 4, 80).astype(np.uint8), s])
        out.append(native.local_align_score_native(q, s, *BLAST))
        out.append(native.local_align_stats_native(q, s, *BLAST))
    nothing = (np.zeros(50, np.uint8), np.full(70, 1, np.uint8))
    out.append(native.local_align_stats_native(*nothing, *BLAST))
    return out


def _seedjoin(native, rng):
    values = rng.integers(0, 1 << 22, 5000).astype(np.int64)
    within = rng.integers(0, 1020, 5000).astype(np.int64)
    frag = rng.integers(0, 6, 5000).astype(np.int64)
    assert native.seed_sort_rows_native(values, within, frag)
    table = np.sort(np.concatenate([values[::3], rng.integers(0, 1 << 22, 3000)]))
    table_pos = rng.integers(0, 100_000, table.size).astype(np.int64)
    joined = native.seed_join_diags_native(table, table_pos, values, within, frag, 6)
    return values, within, frag, joined


def _sketch(native, rng):
    codes = rng.integers(0, 5, 60_000).astype(np.uint8)
    max_hash = port_minhash.max_hash_for_scaled(50)
    return (
        native.sketch_codes_native(codes, 31, max_hash),
        native.sketch_codes_native(codes, 21, 2**64 - 1),
        native.sketch_codes_native(codes[:10], 31, max_hash),
    )


NATIVE_CASES = {
    "suffix_array_and_lcp": _suffix_array,
    "suffix_automaton_streams": _suffix_automaton,
    "chain_cluster_and_dps": _chain,
    "band_affine": _band,
    "align_score_and_stats": _align,
    "seedjoin_sort_and_join": _seedjoin,
    "sketch_codes": _sketch,
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_wrapper_matches_jax_package(libraries, case: str) -> None:
    drive = NATIVE_CASES[case]
    same(
        drive(port_native, np.random.default_rng(101)),
        drive(jax_native, np.random.default_rng(101)),
    )


def test_native_libraries_build_by_rename_with_the_source_hash(
    libraries, monkeypatch, tmp_path
) -> None:
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    lib = _build.load_host_library("chain")
    assert lib is not None and _build.load_host_library("chain") is lib
    (built,) = (tmp_path / "build").iterdir()
    assert built.name.startswith("libchain-host-") and built.suffix == ".so"
    assert _build.BUILD_INFO["host:chain"][0] > 0
    # a changed source gets another file name
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    source = (_build.PACKAGE_DIR / "native" / "chain.cpp").read_text()
    (tmp_path / "chain.cpp").write_text(source + "\n// edited\n")
    assert _build.host_library_path("chain").name != built.name


def test_no_compiler_means_no_native_library(monkeypatch, tmp_path, caplog) -> None:
    """Without g++ a loader returns None (logged at DEBUG) and the
    wrappers report it as the JAX package's do."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with caplog.at_level(logging.DEBUG, logger="pyani_plus_tpu_torch.ops"):
        assert _build.load_host_library("band") is None
    assert "native band unavailable" in caplog.text and "g++ not found" in caplog.text
    one = np.zeros(4, np.uint8)
    assert port_native.band_dp_native(one, one, 60, True, *NUCMER) is None
    assert port_native.local_align_score_native(one, one, *BLAST) is None
    assert port_native.suffix_array_native(np.zeros(4, np.int64)) is None
    assert port_native.seed_sort_rows_native(*(np.zeros(0, np.int64),) * 3) is False
    assert not port_native.have_native()
    # the numpy route of the extension oracle still answers
    a, b = related(np.random.default_rng(4), 200, 0.1)
    assert port_extend.extend_errors(a, b) == jax_extend.extend_errors(a, b)


# ------------------------------------------------------------- numpy ops


def _clusters(mod, rng):
    ref, qry = related(rng, 30_000, 0.06)
    r, q, ln = mod["suffix"].maximal_matches(ref, qry, 20)
    clusters = mod["chaining"].cluster_matches(r, q, ln)
    return r, q, ln, clusters


def _filters(mod, rng):
    blocks, keys = [], []
    for _ in range(60):
        rs, qs = (int(v) for v in rng.integers(0, 90_000, 2))
        span = int(rng.integers(100, 4000))
        blocks.append(
            mod["chaining"].Alignment(
                ref_start=rs, ref_end=rs + span, qry_start=qs,
                qry_end=qs + span + int(rng.integers(-5, 6)),
                errors=int(rng.integers(0, 50)), reverse=bool(rng.integers(0, 2)),
                gap_columns=int(rng.integers(0, 9)), nonid=int(rng.integers(0, 40)),
            )
        )  # fmt: skip
        keys.append((int(rng.integers(0, 2)), int(rng.integers(0, 3))))
    return (
        mod["chaining"].one_to_one(blocks, keys),
        mod["chaining"].many_to_many(blocks, keys),
        mod["chaining"].one_to_one(blocks),
        [(b.columns, b.char_errors, b.ref_len, b.qry_len, b.identity) for b in blocks],
    )


def _local_align(mod, rng):
    out = []
    for length, rate in ((200, 0.05), (900, 0.15)):
        q, s = related(rng, length, rate, n_codes=5)
        out.append(mod["dp"].local_align_stats(q, s))
    out.append(mod["dp"].local_align_stats(np.zeros(30, np.uint8), np.ones(40, np.uint8)))
    stats = out[0]
    return out, stats.pident


def _suffix_numpy(mod, rng):
    data = rng.integers(0, 4, 2000).astype(np.int64)
    sa = mod["suffix"].suffix_array(data)
    return sa, mod["suffix"].lcp_array(data, sa)


def _seeding(mod, rng):
    ref, qry = related(rng, 20_000, 0.04)
    cache = mod["suffix"].SeedIndexCache()
    index = cache.sam_for(ref)
    return (
        mod["suffix"].mum_matches_indexed(index, ref, qry, 20),
        mod["suffix"].max_matches_indexed(index, ref, qry, 20),
        mod["suffix"].maximal_matches(ref, qry, 20, unique_ref=False, unique_qry=False),
        cache.rc_for(qry),
    )


def _seeds(mod, rng):
    subject, frag = related(rng, 6000, 0.08, n_codes=5)
    index = mod["seeds"].SeedIndex(subject)
    q_pos, s_pos = index.hits(frag[1000:2020])
    return (
        mod["seeds"].pack_kmers(subject, 11),
        (index.k, index.values, index.positions),
        (q_pos, s_pos),
        mod["seeds"].candidate_bands(q_pos, s_pos),
        mod["seeds"].bands_from_sorted_diags(np.sort(s_pos - q_pos), max_bands=2),
    )


def _extend_host(mod, rng):
    out = []
    for length, rate in ((50, 0.1), (400, 0.08), (1200, 0.2)):
        a, b = related(rng, length, rate, n_codes=5)
        out.append(mod["extend"].extend_errors(a, b))
        out.append(mod["extend"].gap_errors(a[:80], b[:70]))
        out.append(mod["extend"]._band_dp(a[:150], b[:150], 60, free_end=True,
                                          stop_rows=600, force_numpy=True))  # fmt: skip
    out.append(mod["extend"].extend_errors(np.zeros(0, np.uint8), np.zeros(5, np.uint8)))
    out.append(mod["extend"].gap_errors(np.zeros(0, np.uint8), np.zeros(5, np.uint8)))
    constants = tuple(getattr(mod["extend"], n) for n in ("MATCH", "MISMATCH", "OPEN", "EXTEND", "NEG"))
    return out, constants


def _kmers_and_sketch(mod, rng):
    codes = rng.integers(0, 5, 20_000).astype(np.uint8)
    genome = mod["genomes"].Genome(
        path=Path("x.fna"), md5="0" * 32,
        records=[mod["genomes"].SequenceRecord(b"s1", codes[:12_000]),
                 mod["genomes"].SequenceRecord(b"s2", codes[12_000:])],
    )  # fmt: skip
    sketches = [mod["minhash"].sketch_genome(genome, 21, 20),
                mod["minhash"].sketch_genome(genome, 31, 50)]  # fmt: skip
    return (
        mod["kmers"].canonical_kmer_hashes(codes[:3000], 31),
        mod["kmers"].packed_kmers(codes[:500], 32),
        [s.hashes for s in sketches],
        mod["minhash"].intersection_matrix_host(
            [mod["minhash"].Sketch("a", 21, 20, sketches[0].hashes[::2]),
             mod["minhash"].Sketch("b", 21, 20, sketches[0].hashes[::3]),
             mod["minhash"].Sketch("c", 21, 20, np.empty(0, np.uint64))]
        ),  # fmt: skip
        [mod["minhash"].max_hash_for_scaled(s) for s in (1, 300, 1000)],
    )


def _anim_host_stages(mod, rng):
    ref, qry = related(rng, 25_000, 0.07)
    r, q, ln = mod["suffix"].maximal_matches(ref, qry, 20)
    out = []
    for idx in mod["chaining"].cluster_matches(r, q, ln):
        fill = mod["anim"]._chain_and_fill(ref, qry, r[idx], q[idx], ln[idx])
        tasks = mod["anim"]._extension_tasks(fill, ref, qry)
        ext = [mod["extend"].extend_errors(a, b) for a, b in tasks]
        out.append((fill, tasks, mod["anim"]._assemble_alignment(fill, *ext)))
    blocks = {(0, 0): [entry[2] for entry in out]}
    return out, mod["anim"].score_alignments(blocks), mod["anim"]._interval_union(
        [(5, 9), (1, 6), (20, 22)]
    )


def _dnadiff_features(mod, rng):
    blocks = _filters(mod, rng)[1]
    return mod["dnadiff"].qdiff_features(blocks, 100_000), mod["dnadiff"].configuration()


def _anib_host_stages(mod, rng):
    subject_codes, query_codes = related(rng, 9000, 0.07, n_codes=5)
    query_codes[3000:3070] = 4  # an N run that splits fragments
    genomes = mod["genomes"]
    subject = genomes.Genome(Path("s.fna"), "s" * 32, [genomes.SequenceRecord(b"s", subject_codes)])
    query = genomes.Genome(Path("q.fna"), "q" * 32, [genomes.SequenceRecord(b"q", query_codes)])
    indexes = [mod["seeds"].SeedIndex(subject_codes)]
    frags, per_frag, flat, spans = mod["anib"]._pair_tasks(
        query, subject, indexes, 1020, include_singles=True
    )
    scores = mod["anib"]._score_host(flat)
    return (
        mod["anib"].split_at_n_runs(query_codes),
        frags, per_frag, flat, spans, scores,
        mod["anib"]._pair_finalize(query, subject, frags, per_frag, spans, scores),
        mod["anib"].best_fragment_alignment(frags[1], [subject_codes], indexes),
        mod["anib"]._min_score(1020, 9000),
    )  # fmt: skip


MODULES = {
    "jax": {"chaining": jax_chaining, "dp": jax_dp, "suffix": jax_suffix, "seeds": jax_seeds,
            "extend": jax_extend, "kmers": jax_kmers, "minhash": jax_minhash,
            "genomes": jax_genomes, "anim": jax_anim, "dnadiff": jax_dnadiff, "anib": jax_anib},
    "port": {"chaining": port_chaining, "dp": port_dp, "suffix": port_suffix, "seeds": port_seeds,
             "extend": port_extend, "kmers": port_kmers, "minhash": port_minhash,
             "genomes": port_genomes, "anim": port_anim, "dnadiff": port_dnadiff,
             "anib": port_anib},
}  # fmt: skip
OPS_CASES = {
    "chaining_cluster_matches": _clusters,
    "chaining_filters_and_alignment": _filters,
    "dp_local_align_stats": _local_align,
    "suffix_numpy_array_and_lcp": _suffix_numpy,
    "suffix_indexed_seeding": _seeding,
    "seeds_index_hits_and_bands": _seeds,
    "extend_host_oracle": _extend_host,
    "kmers_minhash_host_half": _kmers_and_sketch,
    "anim_host_stages": _anim_host_stages,
    "dnadiff_qdiff_features": _dnadiff_features,
    "anib_host_stages": _anib_host_stages,
}


@pytest.mark.parametrize("case", sorted(OPS_CASES))
def test_host_module_matches_jax_package(libraries, case: str) -> None:
    drive = OPS_CASES[case]
    same(
        drive(MODULES["port"], np.random.default_rng(202)),
        drive(MODULES["jax"], np.random.default_rng(202)),
    )


def test_owned_pairs_matches_jax_package() -> None:
    from pyani_plus_tpu.parallel.tiles import owned_pairs as jax_owned_pairs

    for n, count in ((3, 2), (5, 3), (4, 1)):
        shares = [owned_pairs(n, index, count) for index in range(count)]
        assert shares == [jax_owned_pairs(n, index, count) for index in range(count)]
        assert sorted(p for share in shares for p in share) == [
            (q, s) for q in range(n) for s in range(n)
        ]


# ------------------------------------------------- genomes, utils, store


@pytest.fixture(scope="module")
def fasta_dir(tmp_path_factory) -> Path:
    directory = tmp_path_factory.mktemp("host_genomes")
    paths = write_genome_dir(directory, 8000, [0.03, 0.1, 0.2], seed=13)
    # a gzipped multi-record genome with lower case, IUPAC letters and Ns
    text = b">c1 first contig\nACGTNNNNacgtRYKM\nTTGACCA\n>c2\nGGGCCCAAATTT\n"
    with gzip.open(directory / "multi.fa.gz", "wb") as handle:
        handle.write(text * 3)
    return paths[0].parent


def test_load_genome_matches_jax_package(fasta_dir: Path) -> None:
    files = port_utils.check_fasta(logging.getLogger(__name__), fasta_dir)
    assert files == jax_utils.check_fasta(logging.getLogger(__name__), fasta_dir)
    assert len(files) == 4
    for path in files:
        got, expected = port_genomes.load_genome(path), jax_genomes.load_genome(path)
        assert got.md5 == expected.md5 == port_utils.file_md5sum(path)
        assert port_utils.file_md5sum(path) == jax_utils.file_md5sum(path)
        assert (got.length, got.n_sequences, got.description) == (
            expected.length, expected.n_sequences, expected.description
        )  # fmt: skip
        for mine, theirs in zip(got.records, expected.records, strict=True):
            assert mine.title == theirs.title and mine.identifier == theirs.identifier
            same(mine.codes, theirs.codes)
            same(port_genomes.complement_codes(mine.codes), jax_genomes.complement_codes(theirs.codes))
            assert port_genomes.decode_sequence(mine.codes) == jax_genomes.decode_sequence(theirs.codes)
    assert port_utils.filename_stem("a.b.fna.gz") == jax_utils.filename_stem("a.b.fna.gz")
    assert port_utils.str_md5sum("ACGT") == jax_utils.str_md5sum("ACGT")
    with pytest.raises(ValueError, match="not found"):
        port_genomes.load_genome(fasta_dir / "absent.fna")


def _fill_store(db_module, genomes_module, path: Path, fasta_dir: Path):
    """A finished 4-genome run with made-up comparisons (a NULL pair, an
    asymmetric pair) written through ``db_module``."""
    rng = np.random.default_rng(31)
    db = db_module.Database(path, create=True)
    config = db.get_or_create_configuration(
        "ANIm", "pyani-plus-tpu-anim", "0.1.0", mode="mum"
    )
    files = sorted(p for p in fasta_dir.iterdir() if p.is_file())
    hashes = []
    for file in files:
        genome = genomes_module.load_genome(file)
        db.add_genome(genome.md5, str(file), genome.length, genome.description)
        hashes.append(genome.md5)
    run = db.add_run(
        config.configuration_id, "made up", str(fasta_dir), "Initialising",
        "host test", [(md5, file.name) for md5, file in zip(hashes, files)],
    )  # fmt: skip
    rows = []
    for qi, q in enumerate(hashes):
        for si, s in enumerate(hashes):
            missing = (qi, si) == (0, 3)
            close = qi // 2 == si // 2
            identity = 1.0 if q == s else float(rng.uniform(0.96, 0.99) if close else rng.uniform(0.8, 0.9))
            rows.append({
                "query_hash": q, "subject_hash": s,
                "identity": None if missing else identity,
                "aln_length": None if missing else int(rng.integers(5000, 8000)),
                "sim_errors": None if missing else int(rng.integers(0, 400)),
                "cov_query": None if missing else float(rng.uniform(0.6, 1.0)),
                "cov_subject": None if missing else float(rng.uniform(0.6, 1.0)),
            })  # fmt: skip
    db.insert_comparisons(rows, configuration_id=config.configuration_id)
    run.cache_comparisons()
    run.set_status("Done")
    return db


def _tree(directory: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir()) if p.is_file()}


@pytest.mark.parametrize(("writer", "reader"), [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_db_round_trip_and_export_across_packages(
    fasta_dir: Path, tmp_path: Path, writer: str, reader: str
) -> None:
    """A store written by one package is read by the other (same schema),
    and both exports of it are the same files."""
    stores = {"port": (port_db, port_genomes), "jax": (jax_db, jax_genomes)}
    written = _fill_store(*stores[writer], tmp_path / "ani.db", fasta_dir)
    written.close()
    reference = _fill_store(jax_db, jax_genomes, tmp_path / "reference.db", fasta_dir)
    logger = logging.getLogger(__name__)
    with stores[reader][0].Database(tmp_path / "ani.db") as db:
        run = db.load_run()
        expected_run = reference.load_run()
        assert run.status == "Done" and run.comparisons_count() == 16
        assert run.genome_hashes == expected_run.genome_hashes
        assert run.comparison_status_counts() == expected_run.comparison_status_counts() == (15, 1)
        assert [dict(r) for r in run.comparisons()] == [dict(r) for r in expected_run.comparisons()]
        assert db.existing_pairs(run.configuration_id, run.genome_hashes) == reference.existing_pairs(
            expected_run.configuration_id, expected_run.genome_hashes
        )
        exporter = port_export if reader == "port" else jax_export
        (tmp_path / "out").mkdir()
        exporter.export_run_tables(logger, db, tmp_path / "out", None, "stem")
    (tmp_path / "expected").mkdir()
    jax_export.export_run_tables(logger, reference, tmp_path / "expected", None, "stem")
    reference.close()
    got, expected = _tree(tmp_path / "out"), _tree(tmp_path / "expected")
    assert sorted(got) == sorted(expected) and len(got) == 7
    assert got == expected


@pytest.mark.parametrize("mode", ["identity", "tANI"])
def test_classify_output_matches_jax_package(fasta_dir: Path, tmp_path: Path, mode: str) -> None:
    logger = logging.getLogger(__name__)
    outputs = {}
    for tag, (db_module, genomes_module, classify) in {
        "port": (port_db, port_genomes, port_classify),
        "jax": (jax_db, jax_genomes, jax_classify),
    }.items():
        db = _fill_store(db_module, genomes_module, tmp_path / f"{tag}.db", fasta_dir)
        out = tmp_path / tag
        out.mkdir()
        classify.classify_run(logger, db, out, run_id=None, mode=mode, label="stem",
                              cov_min=0.5, score_agg="mean", cov_agg="min",
                              vertical_line=0.95, plot=False, formats=("tsv",))  # fmt: skip
        db.close()
        outputs[tag] = _tree(out)
    assert outputs["port"] and outputs["port"] == outputs["jax"]
    assert any(name.endswith(".tsv") for name in outputs["port"])
