"""Entry points: the Gram step on one device, and the multi-device dry run.

Port of the JAX package's ``__graft_entry__.py``:

- :func:`entry` returns the flagship compute step, the sketch-containment
  Gram step (one streamed hash-block update of the all-pairs
  intersection-count tile, the product behind the sourmash method), with
  example arguments on the card.
- :func:`dryrun_multichip` builds an n-device 2D ("q", "s") pair-grid
  mesh and drives the production paths over it on tiny shapes: the
  containment through the mesh, the merge of partial matrices, the
  fragment-batched alignment DP over the flat mesh, and a two-host ANIb
  run through the runner with the mesh as the production mesh.

Where the JAX package takes its devices from ``jax.devices()`` (the
virtual device count on the CPU), the caller names them here: by default
``backend.kernel_devices()`` (every card of the process, or the CPU when
``PYANI_TPU_TORCH_DEVICE=cpu`` asks for it), or a list in which a device
may stand several times (the CPU, or one card named four times for a 2 x 2
mesh). Nothing falls back to the CPU: without a card the caller names it
or asks for it.
"""

from __future__ import annotations

import logging
import os
import tempfile
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from pyani_plus_tpu_torch import backend
from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.ops import sw
from pyani_plus_tpu_torch.ops.minhash import Sketch, containment_ani
from pyani_plus_tpu_torch.parallel import runner, tiles

# The Gram step's tile: genomes a side, and hash ids a block
GRAM_ROWS = 128
GRAM_BLOCK = 512
# The dry run's alignment tasks: fragment and window lengths, and tasks a
# least common multiple of the mesh's sides
DP_ROWS = 64
DP_COLUMNS = 96
DP_TASKS_PER_LCM = 4
# The dry run's ANIb genomes: length, and substitutions a genome
RUN_LENGTH = 900
RUN_RATE = 0.03
RUN_GENOMES = 3


def containment_gram_step(
    counts: torch.Tensor, q_block: torch.Tensor, s_block: torch.Tensor
) -> torch.Tensor:
    """One hash-block update of the pair-tile intersection counts:
    ``counts + q_block @ s_block.T`` in float32 (exact for {0, 1} blocks of
    fewer than 2^24 columns)."""
    return counts + q_block.float() @ s_block.float().T


def entry(device=None):
    """(fn, example_args): the Gram step and zero arguments of the JAX
    shapes, a (128, 128) float32 tile and two (128, 512) int8 blocks, on
    ``device`` (default: ``backend.kernel_device()``, the current card;
    without a card the caller names the CPU, with ``device='cpu'`` or
    ``PYANI_TPU_TORCH_DEVICE=cpu``)."""
    if device is None:
        device = backend.kernel_device("pass device='cpu' or ")
    example_args = (
        torch.zeros((GRAM_ROWS, GRAM_ROWS), dtype=torch.float32, device=device),
        torch.zeros((GRAM_ROWS, GRAM_BLOCK), dtype=torch.int8, device=device),
        torch.zeros((GRAM_ROWS, GRAM_BLOCK), dtype=torch.int8, device=device),
    )
    return containment_gram_step, example_args


def dryrun_mesh(n_devices: int, devices=None) -> tiles.Mesh:
    """The mesh of the first ``n_devices`` of ``devices`` (default:
    ``tiles.make_mesh``'s); raises when there are fewer."""
    mesh = tiles.make_mesh(n_devices, devices=devices)
    if mesh.size < n_devices:
        msg = (
            f"dryrun_multichip needs {n_devices} devices but only {mesh.size} are "
            f"given; name a device several times to stand for more: "
            f"devices=[device] * {n_devices}"
        )
        raise RuntimeError(msg)
    return mesh


def dryrun_sketches(rng: np.random.Generator, n_genomes: int) -> list[Sketch]:
    """The dry run's sketches: 600 draws each from one pool of 4,000
    hashes, so that every pair shares some."""
    pool = rng.choice(np.arange(1, 1 << 20, dtype=np.uint64), 4000, replace=False)
    return [
        Sketch(
            md5=f"g{i}",
            ksize=31,
            scaled=1000,
            hashes=np.unique(rng.choice(pool, 600, replace=False)),
        )
        for i in range(n_genomes)
    ]


def containment_step(
    mesh: tiles.Mesh, sketches: list[Sketch]
) -> tuple[np.ndarray, np.ndarray]:
    """(a) The production containment through the mesh, held equal to the
    host Gram's, the diagonal at 1."""
    identity, cov = containment_ani(sketches, use_device=True, mesh=mesh)
    identity_host, cov_host = containment_ani(sketches, use_device=False)
    assert np.allclose(identity, identity_host, equal_nan=True)
    assert np.allclose(cov, cov_host, equal_nan=True)
    assert np.allclose(np.diag(identity), 1.0)
    return identity, cov


def partial_matrices(rng: np.random.Generator, n_devices: int, n_genomes: int) -> np.ndarray:
    """(n_devices, N, N) float32: device d's zero-masked partial of a
    random matrix, filled over the pairs it owns (``tiles.owned_pairs``)."""
    full = rng.random((n_devices, n_genomes, n_genomes)).astype(np.float32)
    blocks = np.zeros_like(full)
    for d in range(n_devices):
        for q, s in tiles.owned_pairs(n_genomes, d, n_devices):
            blocks[d, q, s] = full[d, q, s]
    return blocks


def merge_step(mesh: tiles.Mesh, blocks: np.ndarray) -> np.ndarray:
    """(b) The partials merged on the mesh, held equal to their sum."""
    merged = tiles.merge_partial_matrices(blocks, mesh)
    assert np.allclose(merged, blocks.sum(axis=0))
    return merged


def alignment_tasks(rng: np.random.Generator, batch: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``batch`` tasks of 64-code fragments in 96-code windows, each
    fragment copied into its window at column 8 (an exact hit)."""
    queries = rng.integers(0, 4, (batch, DP_ROWS)).astype(np.uint8)
    subjects = rng.integers(0, 4, (batch, DP_COLUMNS)).astype(np.uint8)
    subjects[:, 8 : 8 + DP_ROWS] = queries
    return list(zip(queries, subjects))


def alignment_step(mesh: tiles.Mesh, tasks: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """(c) The fragment-batched Smith-Waterman split over the flat mesh,
    one slice a device (the kernel on a card, the plain version on the
    CPU); every planted hit scores ``2 * 64``. Returns the scores."""
    scores = np.array([row[0] for row in sw.batch_sw_best(tasks, list(mesh.devices.flat))])
    assert scores.min() == 2 * DP_ROWS
    return scores


def write_run_genomes(directory: Path) -> Path:
    """Three 900 bp genomes from one ancestor at 0%, 3% and 6%
    substitutions, as FASTA files ``g0.fasta`` ... in ``directory``."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, RUN_LENGTH, dtype=np.uint8)
    bases = np.array(list("ACGT"))
    directory.mkdir(parents=True, exist_ok=True)
    for i in range(RUN_GENOMES):
        codes = base.copy()
        mut = rng.random(codes.size) < RUN_RATE * i
        codes[mut] = (codes[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        (directory / f"g{i}.fasta").write_text(f">g{i}\n" + "".join(bases[codes]) + "\n")
    return directory


@contextmanager
def _environment(values: dict[str, str]):
    """Set environment variables for the block; restore them after."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def runner_step(mesh: tiles.Mesh, fasta_dir: Path, dbfile: Path) -> tuple[int, int]:
    """(d) ANIb through the production runner, its batched Smith-Waterman
    on ``mesh`` as the production mesh, split between two simulated hosts
    (``PYANI_TPU_PROCESS_COUNT=2``): host 0 runs first and stores its
    share, then host 1 resumes the run, computes the rest and finalises
    it. Returns (host 0's comparisons, all comparisons). A mesh of the
    CPU asks for the CPU (``PYANI_TPU_TORCH_DEVICE=cpu``) for the run, a
    mesh of cards for the card.

    The JAX dry run also sets ``PYANI_TPU_ANIB_BATCH`` and ``DEVICE_BATCH``
    to keep its padded batches small on the CPU; the port pads no batch
    and has neither.
    """
    logger = logging.getLogger("dryrun")
    on_cpu = all(d.type == "cpu" for d in mesh.devices.flat)
    env = {"PYANI_TPU_ANIB_DEVICE": "1", "PYANI_TPU_PROCESS_COUNT": "2",
           "PYANI_TPU_PROCESS_INDEX": "0",
           backend.ENV_DEVICE: "cpu" if on_cpu else "cuda"}  # fmt: skip
    with _environment(env), tiles.pair_mesh(mesh):
        run_id = runner.start_and_run_method(logger, dbfile, fasta_dir, "ANIb", create_db=True)
        with Database(dbfile, logger=logger) as db:
            run = db.load_run(run_id)
            part = run.comparisons_count()
            assert 0 < part < RUN_GENOMES**2, part  # host 0 stored only its share
            os.environ["PYANI_TPU_PROCESS_INDEX"] = "1"
            runner.resume_run(logger, db, run)
            run = db.load_run(run_id)
            merged = run.comparisons_count()
            assert merged == RUN_GENOMES**2, merged
            assert run.status == "Done", run.status
            assert np.allclose(np.diag(run.identities.values), 1.0)
    return part, merged


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the production paths once over an ``n_devices`` mesh (tiny
    shapes) and print the JAX dry run's closing line.

    ``devices`` defaults to ``tiles.make_mesh``'s (every card of this
    process, or the CPU when it is requested); give
    ``[torch.device("cpu")] * n`` for the CPU, or one card several times.
    Returns the line's numbers and, per step, the Smith-Waterman kernel's
    launches (0 on the CPU).
    """
    mesh = dryrun_mesh(n_devices, devices)
    nq, ns = mesh.shape
    lcm = int(np.lcm(nq, ns))
    n_genomes = max(8, lcm * 2)
    rng = np.random.default_rng(0)
    identity, _ = containment_step(mesh, dryrun_sketches(rng, n_genomes))
    merge_step(mesh, partial_matrices(rng, mesh.size, n_genomes))
    batch = lcm * DP_TASKS_PER_LCM
    tasks = alignment_tasks(rng, batch)
    before = sw.LAUNCHES
    alignment_step(mesh, tasks)
    aligned = sw.LAUNCHES
    with tempfile.TemporaryDirectory(prefix="dryrun_mesh_") as tmp:
        fasta_dir = write_run_genomes(Path(tmp) / "genomes")
        _, merged = runner_step(mesh, fasta_dir, Path(tmp) / "dry.db")
    launches = {"alignment": aligned - before, "runner": sw.LAUNCHES - aligned}
    print(
        f"dryrun_multichip OK: mesh {mesh.devices.shape} ({n_devices} devices), "
        f"production containment {identity.shape}, dp batch {batch}, "
        f"runner e2e method=ANIb merged_comparisons={merged} status=Done "
        f"(2-host ownership split, device-sharded DP batches)"
    )
    return {"mesh": mesh.shape, "containment": identity.shape, "dp_batch": batch,
            "merged_comparisons": merged, "sw_launches": launches}  # fmt: skip
