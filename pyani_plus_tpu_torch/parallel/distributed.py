"""Multi-process runtime: process group init + collective merge.

Port of ``pyani_plus_tpu/parallel/distributed.py`` onto
``torch.distributed``, with the same names, environment and contract:

- :func:`maybe_initialize` joins a ``torch.distributed`` process group
  from the ``PYANI_TPU_COORDINATOR`` / ``PYANI_TPU_NUM_PROCESSES`` /
  ``PYANI_TPU_PROCESS_ID`` environment (set by the ``launch`` CLI command
  for single-node fan-out, or by hand on a cluster), or, with the
  ``PYANI_TPU_AUTO_DISTRIBUTED`` opt-in, from a SLURM or Open MPI
  launcher's own environment.
- :func:`broadcast_pending` makes host 0's pending-pair view
  authoritative (hosts need not share a database file).
- :func:`allgather_comparisons` is the result merge: every host's
  comparison rows ride an all-gather instead of the reference's polled
  JSON files; host 0 alone writes the store, keeping the
  content-addressed INSERT OR IGNORE idempotence for resume.

The backend is gloo, on the CPU, in every case: the rows are host data at
both ends, and NCCL refuses two ranks on one card (``launch -n 2`` on a
one-card machine puts both workers on it). The cards are not shared
through the group: once it has joined, each process makes card
``local_rank % device_count`` of its node current, so its kernels, streams,
events and allocations all land there (``backend.kernel_device`` returns
the current card).

Rows are encoded losslessly as the JAX package encodes them: MD5 hashes
as 4 uint32 words each, float fields (including the integer-valued ones,
which are far below 2**53) as float64 bit-split into uint32 pairs. They
travel as the int32 tensors of the same bits, since torch's collectives
take no uint32.
"""

from __future__ import annotations

import atexit
import logging
import os
import re
import socket
import subprocess
import sys
import tempfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "PYANI_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "PYANI_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "PYANI_TPU_PROCESS_ID"
ENV_AUTO = "PYANI_TPU_AUTO_DISTRIBUTED"

_FIELDS = ("identity", "aln_length", "sim_errors", "cov_query", "cov_subject")
# row encoding: 4 + 4 uint32 hash words + 5 fields x 2 uint32 words
_ROW_WORDS = 8 + 2 * len(_FIELDS)

# Open MPI's launcher address, e.g. "1531576320.0;tcp://10.96.0.1,10.148.0.1:34911"
_ORTE_URI = "OMPI_MCA_orte_hnp_uri"
_SLURM = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")

_initialized = False


def is_initialized() -> bool:
    return _initialized


def _ephemeral_port(job_id: int) -> int:
    """The port JAX's cluster detection derives from a job id: one of the
    4,096 highest."""
    return job_id % 4096 + 61440


def _slurm_first_node(node_list: str) -> str:
    """The first host of a SLURM node list: 'node001', 'node001,host2',
    'node[001-015],host2' and 'node[001,007-015],host2' give 'node001'."""
    cut = next((i for i, ch in enumerate(node_list) if ch in ",["), len(node_list))
    if node_list[cut : cut + 1] != "[":
        return node_list[:cut]
    ranges = node_list[cut + 1 :]
    return node_list[:cut] + re.split(r"[,\-\]]", ranges, maxsplit=1)[0]


def cluster_environment() -> tuple[str, int, int, int]:
    """(coordinator, world size, rank, local rank) from the environment of
    an Open MPI or SLURM launcher, read as JAX's cluster detection reads
    it (Open MPI first). Raises when neither is complete."""
    env = os.environ
    if _ORTE_URI in env:
        uri = env[_ORTE_URI]
        # the job id is a multiple of 2^12: divide it out first
        port = _ephemeral_port(int(uri.split(".", maxsplit=1)[0]) // 4096)
        match = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
        if match is None:
            msg = f"Could not parse coordinator IP address from {_ORTE_URI}={uri!r}"
            raise RuntimeError(msg)
        host = next(g for g in match.groups() if g is not None)
        return (
            f"{host}:{port}",
            int(env["OMPI_COMM_WORLD_SIZE"]),
            int(env["OMPI_COMM_WORLD_RANK"]),
            int(env["OMPI_COMM_WORLD_LOCAL_RANK"]),
        )
    missing = [name for name in _SLURM if name not in env]
    if missing:
        msg = (
            f"{ENV_AUTO} is set but no complete launcher environment was found "
            f"(Open MPI needs {_ORTE_URI}; SLURM lacks {', '.join(missing)})"
        )
        raise RuntimeError(msg)
    host = _slurm_first_node(env["SLURM_STEP_NODELIST"])
    return (
        f"{host}:{_ephemeral_port(int(env['SLURM_JOB_ID']))}",
        int(env["SLURM_NTASKS"]),
        int(env["SLURM_PROCID"]),
        int(env["SLURM_LOCALID"]),
    )


def _init_method(coordinator: str) -> str:
    host, port = coordinator.rsplit(":", 1)
    if ":" in host and not host.startswith("["):  # an IPv6 address
        host = f"[{host}]"
    return f"tcp://{host}:{port}"


def maybe_initialize(logger: logging.Logger | None = None) -> tuple[int, int]:
    """Join the process group if the launch environment requests one.

    Returns (process_index, process_count); (0, 1) when not distributed.
    Safe to call repeatedly. A group that cannot form raises: the worker
    never carries on alone.
    """
    global _initialized

    if _initialized:
        return dist.get_rank(), dist.get_world_size()
    coordinator = os.environ.get(ENV_COORDINATOR)
    if coordinator:
        num = int(os.environ[ENV_NUM_PROCESSES])
        pid = int(os.environ[ENV_PROCESS_ID])
        local = pid  # `launch` fans out on one node
        how = "Joined distributed runtime"
    elif os.environ.get(ENV_AUTO) and (
        os.environ.get("SLURM_JOB_ID") or os.environ.get("OMPI_COMM_WORLD_SIZE")
    ):
        # Cluster launchers (SLURM srun, Open MPI mpirun) are read only
        # with the explicit opt-in, so plain single-process runs inside
        # a SLURM allocation stay single-process (the reference's SLURM
        # mode likewise needs --executor slurm).
        coordinator, num, pid, local = cluster_environment()
        how = "Joined auto-detected cluster"
    else:
        return 0, 1
    dist.init_process_group(
        "gloo", init_method=_init_method(coordinator), world_size=num, rank=pid
    )
    _initialized = True
    # Leave the group before the interpreter tears down: a gloo group left
    # to the process's own exit can abort it ("terminate called without an
    # active exception"), which a loaded CPU host showed in 13 of 240
    # two-process runs of the collectives, and in none of 240 with this.
    atexit.register(dist.destroy_process_group)
    if torch.cuda.is_available():
        # the workers of a node spread over its cards, and share them when
        # there are more workers than cards
        torch.cuda.set_device(local % torch.cuda.device_count())
    if logger is not None:
        logger.info(
            "%s: process %d of %d (local rank %d, coordinator %s)",
            how,
            dist.get_rank(),
            dist.get_world_size(),
            local,
            coordinator,
        )
    return dist.get_rank(), dist.get_world_size()


def _md5_to_words(md5: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(md5), dtype=np.uint32)


def _words_to_md5(words: np.ndarray) -> str:
    return words.astype("<u4").tobytes().hex()


def _encode_rows(rows: list[dict[str, Any]]) -> np.ndarray:
    out = np.zeros((len(rows), _ROW_WORDS), dtype=np.uint32)
    vals = np.full((len(rows), len(_FIELDS)), np.nan, dtype=np.float64)
    for i, row in enumerate(rows):
        out[i, 0:4] = _md5_to_words(row["query_hash"])
        out[i, 4:8] = _md5_to_words(row["subject_hash"])
        for f, name in enumerate(_FIELDS):
            v = row.get(name)
            if v is not None:
                vals[i, f] = float(v)
    out[:, 8:] = vals.view(np.uint32).reshape(len(rows), 2 * len(_FIELDS))
    return out


def _decode_rows(packed: np.ndarray) -> list[dict[str, Any]]:
    rows: list[dict[str, Any]] = []
    vals = (
        np.ascontiguousarray(packed[:, 8:])
        .view(np.float64)
        .reshape(packed.shape[0], len(_FIELDS))
    )
    for i in range(packed.shape[0]):
        row: dict[str, Any] = {
            "query_hash": _words_to_md5(packed[i, 0:4]),
            "subject_hash": _words_to_md5(packed[i, 4:8]),
        }
        for f, name in enumerate(_FIELDS):
            v = vals[i, f]
            if np.isnan(v):
                row[name] = None
            elif name in ("aln_length", "sim_errors"):
                row[name] = int(v)
            else:
                row[name] = float(v)
        rows.append(row)
    return rows


def _as_tensor(words: np.ndarray):
    """uint32 words as the int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _as_words(tensor) -> np.ndarray:
    return tensor.numpy().view(np.uint32)


def allgather_comparisons(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Collectively merge every host's comparison rows (returned on all).

    An all-gather replaces the reference's shared-filesystem JSON import
    loop (workflows/__init__.py:49-109): counts first, then every host's
    rows padded to the largest count. Duplicate rows from overlapping
    ownership are harmless downstream (INSERT OR IGNORE).
    """
    world = dist.get_world_size()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(rows)], dtype=torch.int64))
    cap = max(int(c.item()) for c in counts)
    padded = np.zeros((max(cap, 1), _ROW_WORDS), dtype=np.uint32)
    if rows:
        padded[: len(rows)] = _encode_rows(rows)
    local = _as_tensor(padded)
    gathered = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(gathered, local)
    merged: list[dict[str, Any]] = []
    for count, words in zip(counts, gathered):
        count = int(count.item())
        if count:
            merged.extend(_decode_rows(_as_words(words)[:count]))
    return merged


def broadcast_pending(
    pending: set[tuple[str, str]],
    process_index: int,
) -> set[tuple[str, str]]:
    """Make host 0's pending-pair set authoritative on every host.

    Hosts may hold private database files (no shared filesystem
    required); only host 0's store decides what still needs computing.
    """
    count = torch.tensor([len(pending) if process_index == 0 else 0], dtype=torch.int64)
    dist.broadcast(count, src=0)
    k = int(count.item())
    buf = np.zeros((max(k, 1), 8), dtype=np.uint32)
    if process_index == 0:
        for i, (q, s) in enumerate(sorted(pending)):
            buf[i, 0:4] = _md5_to_words(q)
            buf[i, 4:8] = _md5_to_words(s)
    words = _as_tensor(buf)
    dist.broadcast(words, src=0)
    buf = _as_words(words)
    return {
        (_words_to_md5(buf[i, 0:4]), _words_to_md5(buf[i, 4:8]))
        for i in range(k)
    }


def launch_local(
    num_processes: int,
    argv: list[str],
    *,
    port: int | None = None,
    timeout: float | None = None,
    quiet: bool = False,
) -> int:
    """Spawn ``num_processes`` copies of this CLI as one process group.

    Single-node fan-out analogue of the reference's Snakemake local
    executor (workflows/__init__.py:158-171), but the workers form a
    real torch.distributed process group and merge results with
    collectives. Returns the worst exit code (124 when ``timeout`` ran
    out and the workers were killed).
    """
    if port is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    procs = []
    logs: list = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        env[ENV_NUM_PROCESSES] = str(num_processes)
        env[ENV_PROCESS_ID] = str(pid)
        # "{rank}" placeholders let each worker use private paths (e.g.
        # --database run_{rank}.db demonstrates that no shared store is
        # needed: results merge through the collective, host 0 persists)
        worker_argv = [a.replace("{rank}", str(pid)) for a in argv]
        # quiet=True keeps worker output off the parent's stdout, but
        # captures it in a temp log that is dumped to stderr on a nonzero
        # exit so failures stay diagnosable.
        sink = (
            tempfile.TemporaryFile(prefix=f"pyani-worker-{pid}-")
            if quiet
            else None
        )
        logs.append(sink)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main", *worker_argv],
                env=env,
                stdout=sink,
                stderr=sink,
            )
        )
    worst = 0
    try:
        for p in procs:
            worst = max(worst, p.wait(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:  # kill exact PIDs we spawned, never by pattern
            if p.poll() is None:
                p.kill()
        worst = 124
    # Reap every child, killed ones included: without this wait their
    # returncode stays None, which leaks zombies and skips the log dump
    # for exactly the hang/timeout case it exists for.
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover - kill raced
            pass
    for pid, (p, log) in enumerate(zip(procs, logs)):
        if log is None:
            continue
        if worst != 0 and p.returncode != 0:
            log.seek(0)
            tail = log.read()[-8192:]
            if tail:
                sys.stderr.write(
                    f"[launch] worker {pid} exited {p.returncode}; "
                    f"output tail:\n{tail.decode(errors='replace')}\n"
                )
        log.close()
    return worst
