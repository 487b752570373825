"""Headline benchmark: 1,000-genome all-vs-all ANI (sourmash mode) on the card.

Port of the JAX package's root-level ``bench.py``, function by function,
with its environment knobs, defaults, seeds and field names:

    python -m pyani_plus_tpu_torch.bench             # the benchmark
    python -m pyani_plus_tpu_torch.bench --warm-only # build and launch each kernel once

It measures end-to-end genome pairs per second for the sourmash method --
host sketching (native C++ kernel), the all-pairs membership Gram on the
card (``ops/minhash.intersection_matrix_device``), the ANI transform --
on synthetic genomes, then classifies the 1,000-genome matrices, times the
device sketch, the extension kernel (B1, ``csrc/extend.cu``) against the
host kernel, one divergent pair and one subject column for each alignment
method (ANIm and dnadiff put their extensions on B1, ANIb its scoring on
B2, ``csrc/sw.cu``), and ``launch -n K`` for K = 1, 2, 4. It prints one
JSON line.

Knobs (bench.py's): ``BENCH_N`` (genomes, 1,000), ``BENCH_LEN`` (bp a
genome, 100,000), ``BENCH_REPS`` (repeats of each timed section, 3),
``BENCH_EXT_LANES`` (extension tasks, 512), ``BENCH_ALN_LEN`` (bp of the
alignment genomes, 400,000), ``BENCH_COL_QUERIES`` (queries down the
column, 12), ``BENCH_METHODS`` and ``BENCH_SCALING`` (0 skips the
alignment or the scaling section), ``BENCH_SCALING_N`` and
``BENCH_SCALING_LEN`` (12 genomes of 20,000 bp), ``BENCH_DEV_SKETCH`` (0
skips the device sketch) and ``BENCH_DEV_SKETCH_N`` (its genomes, 128).
``BENCH_FIXTURES`` names the reference's ``tests/fixtures/viral_example``
directory for the correctness check; unset or absent, the check gives
``null``.

The device: the card unless ``PYANI_TPU_TORCH_DEVICE=cpu`` asks for the
CPU (``backend.py``); without a card and without that request the bench
exits non-zero before it times anything. With the CPU requested it runs
the host paths (the native host kernels and the plain PyTorch Gram) and
skips the device extension section and the device sketch, as bench.py
does off the TPU.

Where bench.py's figures are the TPU's, their meaning here:

- ``compile_seconds``: the seconds of the first Gram call (the CUDA
  context and the first transfers; nothing is compiled);
- ``extend_compile_seconds``: the seconds of the first extension kernel
  call, nvcc included unless ``_build/`` already holds the library;
- ``anib_compile_seconds``: the seconds of the first ANIb call, which
  builds ``csrc/sw.cu`` if it is not built yet;
- ``warm_*_seconds`` (``--warm-only``): the first call of the Gram and of
  each kernel, builds included;
- ``device_name`` and ``device_power_limit`` (not in bench.py): the card
  as ``nvidia-smi --query-gpu=name,power.limit`` gives it, ``null`` with
  the CPU requested.

bench.py's ``extend_shape_buckets`` counts the TPU kernel's compiled
shapes; the CUDA kernel takes any length, so the key is left out. Every
timed call returns host data (numpy arrays, tuples, rows), so the host
clock spans finished card work. The scaling workers run on the card too
(the port's default): they share the one card and split the host's cores,
so the efficiency figures say what the sharing costs, not how the system
scales across cards.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from pyani_plus_tpu_torch import backend

ESTIMATED_REFERENCE_PAIRS_PER_SEC = 1000.0
REPS = max(1, int(os.environ.get("BENCH_REPS", "3")))


def correctness_check() -> float:
    """Max abs error of the sourmash matrices against the reference's
    fixture matrices; NaN when the fixtures are not there."""
    import pandas as pd

    from pyani_plus_tpu_torch.genomes import load_genome
    from pyani_plus_tpu_torch.ops.minhash import containment_ani, sketch_genome
    from pyani_plus_tpu_torch.utils import filename_stem

    fixtures = Path(os.environ.get("BENCH_FIXTURES", ""))
    if fixtures == Path() or not fixtures.is_dir():
        return float("nan")
    fastas = sorted(
        p for ext in (".fasta", ".fas", ".fna") for p in fixtures.glob(f"*{ext}")
    )
    genomes = [load_genome(p) for p in fastas]
    sketches = [sketch_genome(g, 31, 300) for g in genomes]
    identity, cov = containment_ani(sketches, use_device=False)
    stems = [filename_stem(p.name) for p in fastas]
    err = 0.0
    for got, name in ((identity, "sourmash_identity.tsv"), (cov, "sourmash_coverage.tsv")):
        frame = pd.DataFrame(got, index=stems, columns=stems).sort_index(axis=0).sort_index(axis=1)
        expected = (
            pd.read_csv(fixtures / "matrices" / name, sep="\t", index_col=0)
            .sort_index(axis=0)
            .sort_index(axis=1)
        )
        err = max(err, float(np.nanmax(np.abs(frame.values - expected.values))))
    return err


def synth_genomes(n: int, length: int, seed: int = 0) -> list[np.ndarray]:
    """Synthetic related genomes: mutated copies of a few ancestors."""
    rng = np.random.default_rng(seed)
    n_ancestors = max(1, n // 50)
    ancestors = [rng.integers(0, 4, length, dtype=np.uint8) for _ in range(n_ancestors)]
    genomes = []
    for i in range(n):
        base = ancestors[i % n_ancestors].copy()
        rate = rng.uniform(0.001, 0.08)
        mut = rng.random(length) < rate
        base[mut] = (base[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        genomes.append(base)
    return genomes


def mutate(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    out = codes.copy()
    mut = rng.random(out.size) < rate
    out[mut] = (out[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    return out


def _genome_from_codes(codes: np.ndarray, name: str):
    """Wrap raw 0-3 codes as a Genome without touching the filesystem."""
    from pyani_plus_tpu_torch.genomes import Genome, SequenceRecord

    return Genome(
        md5=name,
        path=Path(f"/synthetic/{name}"),
        records=[SequenceRecord(title=name.encode(), codes=codes)],
    )


def extension_tasks(rng, lanes: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """B1's main shape: 1,500-3,200 rows, every 8th task 9,900, at 12%
    substitutions (the draws of bench.py's extension section)."""
    tasks = []
    for i in range(lanes):
        m = int(rng.integers(1500, 3200)) if i % 8 else 9900
        a = rng.integers(0, 4, m).astype(np.uint8)
        tasks.append((a, mutate(a, 0.12, rng)))
    return tasks


def fragment_tasks(rng) -> list[tuple[np.ndarray, np.ndarray]]:
    """B2's main shape: 1,024 fragments of 1,020 rows (every 16th a tail
    of 40-1,019) in windows 300 columns wider, 60% holding the fragment
    at 2-15% substitutions."""
    tasks = []
    for t in range(1024):
        m = 1020 if t % 16 else int(rng.integers(40, 1020))
        q = rng.integers(0, 4, m).astype(np.uint8)
        s = rng.integers(0, 4, m + 300).astype(np.uint8)
        if rng.random() < 0.6:
            left = int(rng.integers(0, 300))
            s[left : left + m] = mutate(q, float(rng.uniform(0.02, 0.15)), rng)
        tasks.append((q, s))
    return tasks


def identity_from_counts(
    counts: np.ndarray, sizes: np.ndarray, ksize: int
) -> tuple[np.ndarray, np.ndarray]:
    """(identity, containment of the row genome in the column genome) from
    the intersection counts and sketch sizes, as bench.py's headline
    computes them (no NaN where nothing is shared)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        c_q = counts / sizes[:, None]
        identity = np.power(np.maximum(c_q, counts / sizes[None, :]), 1.0 / ksize)
    return identity, c_q


def _median_spread(samples: list[float]) -> tuple[float, float, float]:
    """(median, min, max) of a timing sample list."""
    s = sorted(samples)
    return s[len(s) // 2], s[0], s[-1]


def _repeat(fn, reps: int = REPS) -> tuple[float, float, float]:
    """Run ``fn`` (returning wall seconds) ``reps`` times; median stats."""
    return _median_spread([fn() for _ in range(reps)])


def _time_method(method_name: str, genomes: dict, *pairs) -> float:
    """Wall seconds for the given directed comparisons through the
    method's ``compute`` (one call; per-pair = result / len(pairs))."""
    from pyani_plus_tpu_torch.methods import ComputeContext, get_method

    module = get_method(method_name)
    ctx = ComputeContext(
        logger=logging.getLogger("bench"),
        genomes=genomes,
        query_hashes=sorted(genomes),
        subject_hashes=sorted(genomes),
        pending=set(pairs),
        config=module.configuration(),
    )
    t0 = time.time()
    rows = module.compute(ctx)
    assert len(rows) == len(pairs), method_name
    return time.time() - t0


def bench_alignment_methods(rng, on_card: bool) -> dict:  # noqa: PLR0915
    """Per-pair wall times for the alignment methods (one divergent pair),
    and the extension kernel's lanes a second against the host kernel's."""
    from pyani_plus_tpu_torch.ops.extend import batch_extend
    from pyani_plus_tpu_torch.ops.extend_host import extend_errors
    from pyani_plus_tpu_torch.utils import spans

    out: dict = {}
    lanes = int(os.environ.get("BENCH_EXT_LANES", "512"))
    tasks = extension_tasks(rng, lanes)
    if on_card:
        device = backend.kernel_device()
        t0 = time.time()
        batch_extend(tasks, device, stop_rows=600)
        out["extend_compile_seconds"] = round(time.time() - t0, 1)
        # bench.py's TPU shape-ladder warm-up draws these; the kernel has
        # no ladder, but the draws keep the genomes below bench.py's
        for m in (1200, 3400):
            mutate(rng.integers(0, 4, m).astype(np.uint8), 0.1, rng)
        t0 = time.time()
        batch_extend(tasks, device, stop_rows=600)
        out["extend_lanes_per_sec_device"] = round(lanes / (time.time() - t0), 1)
    t0 = time.time()
    for a, b in tasks[: max(8, lanes // 16)]:
        extend_errors(a, b)
    out["extend_lanes_per_sec_host"] = round(max(8, lanes // 16) / (time.time() - t0), 1)

    # --- one divergent (~85% ANI) pair per alignment method
    alen = int(os.environ.get("BENCH_ALN_LEN", "400000"))
    n_col = int(os.environ.get("BENCH_COL_QUERIES", "12"))
    base = rng.integers(0, 4, alen, dtype=np.uint8)
    md5_r = "b" * 32
    md5_q = "a" * 32
    md5_q3 = "d" * 32
    genomes = {md5_r: _genome_from_codes(base, md5_r)}
    col_queries = []
    for i in range(max(n_col, 3)):
        name = f"q{i:02d}" * 8 if i >= 2 else (md5_q, "c" * 32)[i]
        genomes[name] = _genome_from_codes(mutate(base, 0.15, rng), name)
        col_queries.append(name)
    genomes[md5_q3] = _genome_from_codes(mutate(base, 0.15, rng), md5_q3)
    pair = (md5_q, md5_r)
    # the first ANIb call builds csrc/sw.cu unless it is built; the timed
    # figures below are the steady-state cost an all-vs-all run sees
    t0 = time.time()
    _time_method("ANIb", genomes, (md5_q3, md5_r))
    out["anib_compile_seconds"] = round(time.time() - t0, 1)
    for method, key in (
        ("ANIm", "anim_divergent_pair_seconds"),
        ("ANIb", "anib_divergent_pair_seconds"),
        ("fastANI", "fastani_divergent_pair_seconds"),
        ("dnadiff", "dnadiff_divergent_pair_seconds"),
        ("ANIminimap2", "animinimap2_divergent_pair_seconds"),
    ):
        med, lo, hi = _repeat(lambda m=method: _time_method(m, genomes, pair))
        out[key] = round(med, 2)
        out[key + "_spread"] = [round(lo, 2), round(hi, 2)]
    # N = 1,000 all-vs-all projections (10^6 pairs)
    out["animinimap2_projected_days_n1000"] = round(
        out["animinimap2_divergent_pair_seconds"] * 1e6 / 86400.0, 1
    )
    # Warm-subject, column-amortised cost: BENCH_COL_QUERIES queries
    # against the cached subject in one compute() call, so the pair
    # threads and ANIb's group pipeline overlap as down a production
    # column. device_busy_fraction: the share of the column's wall clock
    # with at least one batch on the card (utils/spans' device spans,
    # recorded for the column alone; an upper bound).
    column = [(q, md5_r) for q in col_queries]
    n_pairs = len(column)
    for method, key in (
        ("ANIm", "anim_column_pair_seconds"),
        ("dnadiff", "dnadiff_column_pair_seconds"),
        ("ANIb", "anib_column_pair_seconds"),
    ):
        busy: list[float] = []

        def run_once(m=method, busy=busy):
            with spans.recording():
                w0 = spans.now()
                dt = _time_method(m, genomes, *column)
                busy.append(spans.busy_fraction(w0))
            return dt

        med, lo, hi = _repeat(run_once)
        out[key] = round(med / n_pairs, 2)
        out[key + "_spread"] = [round(lo / n_pairs, 2), round(hi / n_pairs, 2)]
        out[key.replace("_column_pair_seconds", "_device_busy_fraction")] = round(
            sorted(busy)[len(busy) // 2], 3
        )
    out["device_busy_fraction"] = out["anib_device_busy_fraction"]
    for method in ("anim", "dnadiff", "anib"):
        out[f"{method}_projected_days_n1000"] = round(
            out[f"{method}_column_pair_seconds"] * 1e6 / 86400.0, 1
        )
    return out


def bench_multihost_scaling() -> dict:
    """Scaling curve: ``launch -n K`` over a synthetic ANIm all-vs-all.

    Measures the process group (host 0's pending broadcast, the
    all-gather merge, private stores a worker) for K in {1, 2, 4}.
    Start-up (a ``--version`` launch) is timed apart and subtracted, so
    the efficiency figure reflects the compute and merge path. The
    workers run where the port runs (the one card, or the CPU when it is
    requested), one pair at a time and one core a pair.
    """
    from pyani_plus_tpu_torch.db import Database
    from pyani_plus_tpu_torch.parallel.distributed import launch_local

    n = int(os.environ.get("BENCH_SCALING_N", "12"))
    length = int(os.environ.get("BENCH_SCALING_LEN", "20000"))
    rng = np.random.default_rng(7)
    ancestors = [rng.integers(0, 4, length, dtype=np.uint8) for _ in range(2)]
    bases = np.array(list("ACGT"))
    tmp = Path(tempfile.mkdtemp(prefix="pyani_scaling_"))
    out: dict = {}
    try:
        fasta_dir = tmp / "genomes"
        fasta_dir.mkdir()
        for i in range(n):
            codes = ancestors[i % len(ancestors)].copy()
            rate = 0.02 + 0.06 * (i / n)
            mut = rng.random(length) < rate
            codes[mut] = (codes[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            seq = "".join(bases[codes])
            with (fasta_dir / f"g{i:03d}.fasta").open("w") as fh:
                fh.write(f">g{i:03d}\n")
                for lo in range(0, length, 60):
                    fh.write(seq[lo : lo + 60] + "\n")

        os.environ["PYANI_TPU_PAIR_WORKERS"] = "1"  # 1 pair at a time
        # one core a process: launch owns the parallelism, so the pools
        # within a pair must not oversubscribe the host
        os.environ["PYANI_TPU_INTRA_WORKERS"] = "1"
        walls: dict[int, float] = {}
        starts: dict[int, float] = {}
        for k in (1, 2, 4):
            t0 = time.time()
            assert launch_local(k, ["--version"], timeout=120, quiet=True) == 0
            starts[k] = time.time() - t0
            run_dir = tmp / f"run{k}"
            run_dir.mkdir()
            t0 = time.time()
            code = launch_local(
                k,
                ["anim", str(fasta_dir), "-d", str(run_dir / "ani_{rank}.db"), "--create-db"],
                timeout=1800,
                quiet=True,
            )
            walls[k] = time.time() - t0
            assert code == 0, f"scaling run K={k} failed"
            # host 0's store must hold the complete merged run
            with Database(run_dir / "ani_0.db") as db:
                (run,) = db.list_runs()
                assert run.status == "Done"
                assert run.comparisons_count() == n * n
        pairs = n * n
        compute1 = walls[1] - starts[1]
        out["scaling_n_processes"] = [1, 2, 4]
        out["scaling_pairs_per_sec"] = [round(pairs / walls[k], 1) for k in (1, 2, 4)]
        out["scaling_wall_seconds"] = [round(walls[k], 1) for k in (1, 2, 4)]
        out["scaling_startup_seconds"] = [round(starts[k], 1) for k in (1, 2, 4)]
        for k in (2, 4):
            out[f"scaling_efficiency_n{k}"] = round(compute1 / (k * (walls[k] - starts[k])), 2)
        out["scaling_host_cores"] = os.cpu_count()
        # headline efficiency at the largest K the host's cores cover
        k_eff = 4 if (os.cpu_count() or 2) >= 4 else 2
        out["scaling_efficiency"] = out[f"scaling_efficiency_n{k_eff}"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _device_or_exit() -> bool:
    """True on the card, False with the CPU requested; exits with
    ``backend.py``'s message when the card is requested and absent."""
    try:
        return backend.on_card()
    except (RuntimeError, ValueError) as err:
        sys.exit(f"bench: {err}")


def warm_only() -> None:
    """Build and launch each kernel once, at its main shape, and print one
    JSON line with the seconds of each first call. With the CPU requested
    only the Gram runs."""
    on_card = _device_or_exit()
    out: dict = {"mode": "warm-only"}
    rng = np.random.default_rng(0)

    t0 = time.time()
    from pyani_plus_tpu_torch.ops.minhash import Sketch, intersection_matrix_device

    sketches = [
        Sketch("w", 31, 1000, np.sort(rng.integers(0, 2**63, 200).astype(np.uint64)))
        for _ in range(64)
    ]
    intersection_matrix_device(sketches)
    out["warm_gram_seconds"] = round(time.time() - t0, 1)

    if on_card:
        from pyani_plus_tpu_torch.ops.extend import batch_extend
        from pyani_plus_tpu_torch.ops.sw import batch_sw_best

        device = backend.kernel_device()
        tasks = extension_tasks(rng, 512)
        t0 = time.time()
        batch_extend(tasks, device, stop_rows=600)
        out["warm_extend_seconds"] = round(time.time() - t0, 1)

        tasks = fragment_tasks(rng)
        t0 = time.time()
        batch_sw_best(tasks, device)
        out["warm_anib_dp_seconds"] = round(time.time() - t0, 1)
    print(json.dumps(out))


def _card() -> tuple[str | None, str | None]:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = backend.probe().smi
    if not smi:
        return None, None
    name, _, limit = smi.rpartition(",")
    return name.strip(), limit.strip()


def main() -> None:  # noqa: PLR0915
    on_card = _device_or_exit()
    n = int(os.environ.get("BENCH_N", "1000"))
    length = int(os.environ.get("BENCH_LEN", "100000"))
    ksize, scaled = 31, 1000

    err = correctness_check()

    from pyani_plus_tpu_torch.native import sketch_codes_native
    from pyani_plus_tpu_torch.ops.minhash import (
        Sketch,
        intersection_matrix_device,
        max_hash_for_scaled,
    )

    genomes = synth_genomes(n, length)
    max_hash = max_hash_for_scaled(scaled)

    def _sketch_one(codes):
        h = sketch_codes_native(codes, ksize, max_hash)
        if h is None:  # no compiler: the numpy path, host code as well
            from pyani_plus_tpu_torch.ops.kmers import canonical_kmer_hashes

            h = canonical_kmer_hashes(codes, ksize)
            h = h[h <= np.uint64(max_hash)]
        return np.unique(h)

    # The native murmur kernel releases the GIL, so genomes sketch in
    # parallel across host cores.
    sketch_samples = []
    for _ in range(REPS):
        t0 = time.time()
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            sketches = list(pool.map(_sketch_one, genomes))
        sketch_samples.append(time.time() - t0)
    t_sketch, t_sketch_lo, t_sketch_hi = _median_spread(sketch_samples)

    # All-pairs containment: compact ids, then the blocked membership Gram
    # on the device (ops/minhash.intersection_matrix_device)
    sizes = np.array([s.size for s in sketches], dtype=np.float64)
    sketch_objs = [Sketch("x", ksize, scaled, s) for s in sketches]
    t_c = time.time()
    intersection_matrix_device(sketch_objs)
    t_compile = time.time() - t_c
    device_samples = []
    for _ in range(REPS):
        t1 = time.time()
        counts = intersection_matrix_device(sketch_objs).astype(np.float64)
        device_samples.append(time.time() - t1)
    identity, c_q = identity_from_counts(counts, sizes, ksize)
    t_device, t_device_lo, t_device_hi = _median_spread(device_samples)

    pairs = n * n
    value = pairs / (t_sketch + t_device)
    # spread: best case = both stages at their min, worst = both at max
    value_lo = pairs / (t_sketch_hi + t_device_hi)
    value_hi = pairs / (t_sketch_lo + t_device_lo)

    # classify over the full matrices: clique recursion on the
    # thresholded graph, identity as score and containment as coverage
    import pandas as pd

    from pyani_plus_tpu_torch.report.classify import (
        construct_graph,
        find_cliques_recursively,
        find_initial_cliques,
        get_unique_cliques,
    )

    labels = [f"g{i}" for i in range(n)]
    t0 = time.time()
    id_df = pd.DataFrame(identity, index=labels, columns=labels)
    cov_df = pd.DataFrame(c_q, index=labels, columns=labels)
    graph = construct_graph(cov_df, id_df, min, np.mean, 0.5)
    cliques = get_unique_cliques(find_initial_cliques(graph), find_cliques_recursively(graph))
    t_classify = time.time() - t0

    gram = "CUDA membership Gram" if on_card else "PyTorch membership Gram on the CPU"
    device_name, device_power_limit = _card() if on_card else (None, None)
    result = {
        "metric": (
            f"sourmash-mode all-vs-all ANI, {n} genomes x {length} bp "
            f"(host native sketch + {gram})"
        ),
        "value": round(value, 1),
        "value_median": round(value, 1),
        "value_spread": [round(value_lo, 1), round(value_hi, 1)],
        "timing_reps": REPS,
        "unit": "pairs/sec/chip",
        "vs_baseline": round(value / ESTIMATED_REFERENCE_PAIRS_PER_SEC, 2),
        "fixture_max_abs_err": None if err != err else err,
        "sketch_seconds": round(t_sketch, 2),
        "device_seconds": round(t_device, 2),
        "compile_seconds": round(t_compile, 2),
        "identity_mean": float(np.nanmean(identity)),
        "classify_seconds": round(t_classify, 2),
        "classify_cliques": len(cliques),
        "device_name": device_name,
        "device_power_limit": device_power_limit,
    }
    # The device sketch, bit-identical to the native one, timed on a
    # subset of the genomes and projected linearly to the full set
    if on_card and os.environ.get("BENCH_DEV_SKETCH", "1") != "0":
        from pyani_plus_tpu_torch.ops.minhash import sketch_genomes_device

        dev_n = min(n, int(os.environ.get("BENCH_DEV_SKETCH_N", "128")))
        dev_genomes = [_genome_from_codes(c, f"d{i}") for i, c in enumerate(genomes[:dev_n])]
        sketch_genomes_device(dev_genomes, ksize, scaled)  # warm
        t0 = time.time()
        dev_sketches = sketch_genomes_device(dev_genomes, ksize, scaled)
        t_dev_sketch = time.time() - t0
        assert all(
            np.array_equal(np.asarray(ds.hashes), sketches[i]) for i, ds in enumerate(dev_sketches)
        )
        result["sketch_seconds_device_projected"] = round(t_dev_sketch * (n / dev_n), 2)
    if os.environ.get("BENCH_METHODS", "1") != "0":
        result.update(bench_alignment_methods(np.random.default_rng(9), on_card))
    if os.environ.get("BENCH_SCALING", "1") != "0":
        result.update(bench_multihost_scaling())
    print(json.dumps(result))


if __name__ == "__main__":
    if "--warm-only" in sys.argv:
        warm_only()
    else:
        main()
