"""The port's process group against the JAX package's, on the CPU.

- The row codec: the words the port encodes are the JAX package's, byte
  for byte, and decode back exactly.
- Joining a group: the explicit environment (``launch``) and the opted-in
  SLURM and Open MPI environments give the rank, size, local rank and
  coordinator that JAX's own cluster detection derives, and the group is
  gloo over ``tcp://``; without the opt-in there is no group, and a group
  that cannot form raises.
- The collectives between real processes: host 0's pending set reaches
  every host, and every host's rows reach every host.
- ``launch -n 2`` and ``-n 4``: real worker processes with private
  databases, for sourmash and ANIm; host 0's ``export-run`` tables equal
  a single-process port run's and the JAX package's CLI run's (integers
  exact, floats equal), and the other hosts hold only their share. A
  failed worker fails the launch; a hung group is killed at the timeout
  with every child reaped; the workers import neither ``jax`` nor the
  JAX package.
- A worker makes card ``local_rank % device_count`` current, and
  ``backend.kernel_device`` returns it.

Every subprocess has a timeout well inside the suite's limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

import pyani_plus_tpu.parallel.distributed as jax_dist
from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu_torch import backend
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.parallel import distributed
from pyani_plus_tpu_torch.synthetic import write_genome_dir

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 180  # seconds for any launch or subprocess here

# command -> (method name, its options)
METHODS = {"sourmash": ("sourmash", ["--scaled", "100"]), "anim": ("ANIm", [])}

# ------------------------------------------------------------ row codec

JAX_TEST_ROWS = [  # tests/test_distributed.py's rows
    {
        "query_hash": "5584c7029328dc48d33f95f0a78f7e57",
        "subject_hash": "689d3fd6881db36b5e08329cf23cecdd",
        "identity": 0.9962487643734,
        "aln_length": 39169,
        "sim_errors": 222,
        "cov_query": 0.99,
        "cov_subject": None,
    },
    {
        "query_hash": "0" * 32,
        "subject_hash": "f" * 32,
        "identity": None,
        "aln_length": None,
        "sim_errors": None,
        "cov_query": None,
        "cov_subject": None,
    },
]


def _random_rows(seed: int, count: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        none = rng.random() < 0.2
        aln = int(rng.integers(0, 1 << 40))
        rows.append(
            {
                "query_hash": rng.bytes(16).hex(),
                "subject_hash": rng.bytes(16).hex(),
                "identity": None if none else float(rng.random()),
                "aln_length": None if none else aln,
                "sim_errors": None if none else int(rng.integers(0, aln + 1)),
                "cov_query": None if none else float(rng.random()) / 3,
                "cov_subject": None if none else float(np.nextafter(1.0, 0.0)),
            }
        )
    return rows


ROW_SETS = {"jax_test": JAX_TEST_ROWS, "random": _random_rows(seed=8, count=40)}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_row_codec_is_the_jax_codec(name: str) -> None:
    rows = ROW_SETS[name]
    words = distributed._encode_rows(rows)
    expected = jax_dist._encode_rows(rows)
    assert words.dtype == expected.dtype == np.uint32
    assert words.shape == (len(rows), distributed._ROW_WORDS)
    assert words.tobytes() == expected.tobytes()
    assert distributed._decode_rows(words) == rows == jax_dist._decode_rows(expected)
    # through the int32 tensor the collectives carry, and back
    assert distributed._as_words(distributed._as_tensor(words)).tobytes() == words.tobytes()


def test_row_codec_takes_no_rows() -> None:
    """A host with no rows encodes to no words. The JAX package's encoder
    raises here (its reshape to (0, -1)), and its all-gather encodes
    unconditionally; the port's encodes only rows it has."""
    with pytest.raises(ValueError, match="cannot reshape"):
        jax_dist._encode_rows([])
    words = distributed._encode_rows([])
    assert words.shape == (0, distributed._ROW_WORDS) and words.dtype == np.uint32
    assert distributed._decode_rows(words) == []


# ------------------------------------------------------------ joining a group


@pytest.fixture
def fresh_group(monkeypatch) -> list[dict]:
    """No group joined; ``init_process_group`` records its arguments
    instead of joining, and rank and size read from them. Four cards are
    faked (none is touched): the card a worker makes current is recorded
    as the call's "card"."""
    calls: list[dict] = []
    current = [0]
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])

    def init(backend, **kwargs):
        calls.append({"backend": backend, **kwargs})

    def set_device(index: int) -> None:
        current[0] = index
        calls[-1]["card"] = index

    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    # what the worker does at exit is recorded as the call's "at_exit"
    monkeypatch.setattr(distributed, "atexit",
                        types.SimpleNamespace(register=lambda fn: calls[-1].update(at_exit=fn)))  # fmt: skip
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: calls[-1]["rank"])
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: calls[-1]["world_size"])
    for name in (distributed.ENV_COORDINATOR, distributed.ENV_AUTO, "SLURM_JOB_ID",
                 "OMPI_COMM_WORLD_SIZE", distributed._ORTE_URI, *distributed._SLURM):  # fmt: skip
        monkeypatch.delenv(name, raising=False)
    return calls


def test_explicit_environment_joins_gloo_over_tcp(fresh_group, monkeypatch) -> None:
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:29517")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "3")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "2")
    assert distributed.maybe_initialize() == (2, 3)
    assert fresh_group == [
        {"backend": "gloo", "init_method": "tcp://127.0.0.1:29517", "world_size": 3, "rank": 2,
         "card": 2,  # the process id is the local rank under `launch`
         "at_exit": torch.distributed.destroy_process_group}
    ]  # fmt: skip
    assert distributed.is_initialized()
    assert distributed.maybe_initialize() == (2, 3)  # safe to call again
    assert len(fresh_group) == 1


SLURM_NODE_LISTS = ["node001", "node001,host2", "node[001-0015],host2", "node[001,007-015],host2"]


@pytest.mark.parametrize("node_list", SLURM_NODE_LISTS)
def test_slurm_environment_is_read_as_jax_reads_it(fresh_group, monkeypatch, node_list: str) -> None:
    from jax._src.clusters import SlurmCluster

    env = {"SLURM_JOB_ID": "424242", "SLURM_STEP_NODELIST": node_list, "SLURM_NTASKS": "7",
           "SLURM_PROCID": "3", "SLURM_LOCALID": "1", distributed.ENV_AUTO: "1"}  # fmt: skip
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert SlurmCluster.is_env_present()
    expected = (
        SlurmCluster.get_coordinator_address(None, None),
        SlurmCluster.get_process_count(),
        SlurmCluster.get_process_id(),
        SlurmCluster.get_local_process_id(),
    )
    assert distributed.cluster_environment() == expected
    assert distributed.maybe_initialize() == (3, 7)
    (call,) = fresh_group
    assert call == {"backend": "gloo", "init_method": f"tcp://{expected[0]}",
                    "world_size": 7, "rank": 3, "card": 1,
                    "at_exit": torch.distributed.destroy_process_group}  # fmt: skip


ORTE_URIS = [
    "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
    "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370",
]


@pytest.mark.parametrize("uri", ORTE_URIS, ids=["tcp", "tcp6"])
def test_open_mpi_environment_is_read_as_jax_reads_it(fresh_group, monkeypatch, uri: str) -> None:
    from jax._src.clusters import OmpiCluster

    env = {distributed._ORTE_URI: uri, "OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2",
           "OMPI_COMM_WORLD_LOCAL_RANK": "0", distributed.ENV_AUTO: "1",
           "SLURM_JOB_ID": "99"}  # an mpirun inside a SLURM allocation  # fmt: skip
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert OmpiCluster.is_env_present()
    expected = (
        OmpiCluster.get_coordinator_address(None, None),
        OmpiCluster.get_process_count(),
        OmpiCluster.get_process_id(),
        OmpiCluster.get_local_process_id(),
    )
    assert distributed.cluster_environment() == expected
    assert distributed.maybe_initialize() == (2, 4)
    host, port = expected[0].rsplit(":", 1)
    url = f"tcp://[{host}]:{port}" if ":" in host else f"tcp://{expected[0]}"
    assert fresh_group[0]["init_method"] == url
    assert fresh_group[0]["card"] == 0  # the launcher's local rank


@pytest.mark.parametrize("launcher", ["slurm", "mpi"])
def test_no_group_without_the_opt_in(fresh_group, monkeypatch, launcher: str) -> None:
    if launcher == "slurm":
        monkeypatch.setenv("SLURM_JOB_ID", "424242")
    else:
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    assert distributed.maybe_initialize() == (0, 1)
    assert not fresh_group and not distributed.is_initialized()


def test_a_group_that_cannot_form_raises(fresh_group, monkeypatch) -> None:
    """An opted-in launcher environment that is incomplete, and a failed
    join, both raise: the worker never carries on alone."""
    monkeypatch.setenv(distributed.ENV_AUTO, "1")
    monkeypatch.setenv("SLURM_JOB_ID", "424242")
    with pytest.raises(RuntimeError, match="SLURM lacks SLURM_STEP_NODELIST"):
        distributed.maybe_initialize()
    assert not fresh_group and not distributed.is_initialized()

    def refuse(*args, **kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "1")
    with pytest.raises(RuntimeError, match="connection refused"):
        distributed.maybe_initialize()
    assert not distributed.is_initialized()


@pytest.mark.parametrize(
    ("rank", "count", "expected"),
    [(0, 1, "cuda:0"), (1, 1, "cuda:0"), (1, 2, "cuda:1"), (3, 2, "cuda:1"), (1, 0, "cpu")],
)
def test_kernel_device_takes_the_local_ranks_card(fresh_group, monkeypatch, rank: int,
                                                  count: int, expected: str) -> None:  # fmt: skip
    """A worker joining a group makes card ``local rank % cards`` current,
    and the kernels run on the current card."""
    report = backend.DeviceReport(
        cuda=count > 0, capability=(9, 0) if count else None, device_name=None,
        device_count=count, torch_version="", torch_cuda=None, nvcc=None,
        nvcc_version=None, smi=None,
    )  # fmt: skip
    monkeypatch.setattr(backend, "probe", lambda: report)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:29517")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, str(rank + 1))
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, str(rank))
    assert distributed.maybe_initialize() == (rank, rank + 1)
    assert backend.kernel_device() == torch.device(expected)
    assert ("card" in fresh_group[0]) == (count > 0)


# ------------------------------------------------------------ collectives

COLLECTIVES = """
import json, sys
from pyani_plus_tpu_torch.parallel import distributed
rows = json.loads(sys.argv[1])
pending = {tuple(p) for p in json.loads(sys.argv[2])}
rank, world = distributed.maybe_initialize()
got = distributed.broadcast_pending(pending, rank)
merged = distributed.allgather_comparisons(rows)
print(json.dumps({"rank": rank, "world": world, "pending": sorted(got), "merged": merged}))
"""


def _env(**extra: str) -> dict[str, str]:
    path = [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]
    return {**os.environ, "PYTHONPATH": os.pathsep.join(path), "OMP_NUM_THREADS": "1", **extra}


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_between_processes(world: int, unused_port: int) -> None:
    """Host 0's pending set reaches every host (the others offer other
    sets, which must be ignored); every host receives every host's rows
    in rank order, a host with none included."""
    rows = _random_rows(seed=21, count=7)
    shares = {2: [rows[:4], rows[4:]], 3: [rows[:4], [], rows[4:]]}[world]
    pending = [[[q, s] for q, s in {(r["query_hash"], r["subject_hash"]) for r in rows}]]
    pending += [[["a" * 32, "b" * 32]]] * (world - 1)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", COLLECTIVES, json.dumps(shares[rank]), json.dumps(pending[rank])],
            env=_env(PYANI_TPU_COORDINATOR=f"127.0.0.1:{unused_port}",
                     PYANI_TPU_NUM_PROCESSES=str(world), PYANI_TPU_PROCESS_ID=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )  # fmt: skip
        for rank in range(world)
    ]
    outputs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, err
            outputs.append(json.loads(out.splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    expected_pending = sorted(tuple(p) for p in pending[0])
    for rank, out in enumerate(outputs):
        assert (out["rank"], out["world"]) == (rank, world)
        assert [tuple(p) for p in out["pending"]] == expected_pending
        assert out["merged"] == [row for share in shares for row in share]


@pytest.fixture
def unused_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ launch


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory) -> Path:
    directory = tmp_path_factory.mktemp("launch_genomes")
    write_genome_dir(directory, 50_000, [0.02, 0.08, 0.15], seed=13)
    return directory


def _read(path: Path) -> pd.DataFrame:
    frame = pd.read_csv(path, sep="\t", index_col=0)
    frame.index = frame.index.map(str)
    frame = frame.sort_index(axis=0).sort_index(axis=1)
    if path.name.endswith("_run_1.tsv"):  # long form, rows in completion order
        frame = frame.sort_values(list(frame.columns))
    return frame


def _export(app, db: Path, out: Path) -> dict[str, pd.DataFrame]:
    result = CliRunner().invoke(app, ["export-run", "-d", str(db), "-o", str(out)],
                                catch_exceptions=False)  # fmt: skip
    assert result.exit_code == 0, result.output
    tables = {p.name: _read(p) for p in sorted(out.glob("*.tsv"))}
    assert len(tables) == 7
    return tables


@pytest.fixture(scope="module")
def single_runs(genome_dir, tmp_path_factory) -> dict[str, dict[str, dict[str, pd.DataFrame]]]:
    """command -> {"torch": tables, "jax": tables} of one process each."""
    work = tmp_path_factory.mktemp("single_runs")
    out: dict = {}
    for command, (_method, options) in METHODS.items():
        out[command] = {}
        for tag, app in (("torch", torch_app), ("jax", jax_app)):
            db = work / f"{command}_{tag}.db"
            args = [command, str(genome_dir), "-d", str(db), "--create-db",
                    "--cache", str(work / f"cache_{tag}"), *options]  # fmt: skip
            result = CliRunner().invoke(app, args, catch_exceptions=False)
            assert result.exit_code == 0, result.output
            out[command][tag] = _export(app, db, work / f"out_{command}_{tag}")
    return out


def _stored(db: Path) -> tuple[int, str]:
    with Database(db) as store:
        (run,) = store.list_runs()
        return run.comparisons_count(), run.status


# The workers' interpreters refuse jax and the JAX package, and each
# writes down at exit which of them it holds (none, or it would not run).
SITE_HOOK = """
import atexit, os, sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"):
            raise ImportError("refused in this test: " + name)
sys.meta_path.insert(0, _Refuse())
@atexit.register
def _report():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"))
    path = os.path.join(os.environ["IMPORT_REPORT_DIR"], str(os.getpid()))
    with open(path, "w") as handle:
        handle.write(repr(loaded))
"""


@pytest.mark.parametrize("command", sorted(METHODS))
def test_launch_two_workers_private_stores(command: str, genome_dir, single_runs, tmp_path,
                                           monkeypatch) -> None:  # fmt: skip
    """The `launch` command, two workers with private databases: host 0's
    run is Done and its tables are the single-process runs'; host 1's
    store holds its share only; neither worker imported JAX."""
    hook = tmp_path / "hook"
    reports = tmp_path / "imports"
    hook.mkdir()
    reports.mkdir()
    (hook / "sitecustomize.py").write_text(SITE_HOOK)
    monkeypatch.setenv("PYTHONPATH", f"{hook}{os.pathsep}{_env()['PYTHONPATH']}")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("IMPORT_REPORT_DIR", str(reports))
    _method, options = METHODS[command]
    db = tmp_path / "ani_{rank}.db"
    args = ["launch", "-n", "2", "--", command, str(genome_dir), "-d", str(db), "--create-db",
            "--cache", str(tmp_path / "cache_{rank}"), *options]  # fmt: skip
    result = CliRunner().invoke(torch_app, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert sorted(p.read_text() for p in reports.iterdir()) == ["[]", "[]"]
    assert _stored(tmp_path / "ani_0.db") == (9, "Done")
    count, _status = _stored(tmp_path / "ani_1.db")
    assert 0 < count < 9
    tables = _export(torch_app, tmp_path / "ani_0.db", tmp_path / "out")
    for tag in ("torch", "jax"):
        expected = single_runs[command][tag]
        assert sorted(tables) == sorted(expected)
        for name, frame in tables.items():
            pd.testing.assert_frame_equal(frame, expected[name], check_exact=True,
                                          obj=f"{name} vs {tag}")  # fmt: skip


def test_launch_four_workers_merges_exactly(genome_dir, single_runs, tmp_path) -> None:
    db = tmp_path / "ani_{rank}.db"
    code = distributed.launch_local(
        4,
        ["sourmash", str(genome_dir), "-d", str(db), "--create-db",
         "--cache", str(tmp_path / "cache_{rank}"), *METHODS["sourmash"][1]],
        timeout=TIMEOUT, quiet=True,
    )  # fmt: skip
    assert code == 0
    assert _stored(tmp_path / "ani_0.db") == (9, "Done")
    shares = [_stored(tmp_path / f"ani_{rank}.db")[0] for rank in range(1, 4)]
    assert all(0 < share < 9 for share in shares)
    assert sum(shares) + 3 == 9  # host 0 owns 3 of the 9 pairs: no overlap
    tables = _export(torch_app, tmp_path / "ani_0.db", tmp_path / "out")
    for name, frame in tables.items():
        pd.testing.assert_frame_equal(frame, single_runs["sourmash"]["jax"][name],
                                      check_exact=True, obj=name)  # fmt: skip


def test_a_host_without_pairs_joins_the_merge(genome_dir, tmp_path) -> None:
    """One genome, two workers: host 1 owns no pair and joins the gather
    with no rows (where the JAX package's encoder raises and leaves host 0
    waiting in the gather)."""
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(genome_dir / "genome_0.fna", one)
    code = distributed.launch_local(
        2,
        ["sourmash", str(one), "-d", str(tmp_path / "ani_{rank}.db"), "--create-db",
         "--cache", str(tmp_path / "cache"), *METHODS["sourmash"][1]],
        timeout=TIMEOUT, quiet=True,
    )  # fmt: skip
    assert code == 0
    assert _stored(tmp_path / "ani_0.db") == (1, "Done")
    assert _stored(tmp_path / "ani_1.db")[0] == 0


def test_a_failed_worker_fails_the_launch(genome_dir, tmp_path, capfd) -> None:
    """Worker 1's input is missing: it exits nonzero, worker 0 cannot go
    on alone, and the launch reports both tails."""
    (tmp_path / "genomes_0").symlink_to(genome_dir)
    code = distributed.launch_local(
        2,
        ["sourmash", str(tmp_path / "genomes_{rank}"), "-d", str(tmp_path / "ani_{rank}.db"),
         "--create-db", "--cache", str(tmp_path / "cache")],
        timeout=TIMEOUT, quiet=True,
    )  # fmt: skip
    assert code != 0
    err = capfd.readouterr().err
    assert "[launch] worker 1 exited" in err and "is not a directory" in err
    assert "[launch] worker 0 exited" in err


def test_a_hung_group_is_killed_at_the_timeout(genome_dir, tmp_path, monkeypatch) -> None:
    """Worker 0 blocks reading a FIFO it takes for a genome, so worker 1
    waits for it in the group's broadcast: the launch kills both at the
    timeout, returns 124 and reaps every child."""
    stuck = tmp_path / "genomes_0"
    shutil.copytree(genome_dir, stuck)
    os.mkfifo(stuck / "blocked.fna")
    (tmp_path / "genomes_1").symlink_to(genome_dir)
    spawned: list[subprocess.Popen] = []
    real = subprocess.Popen

    def record(*args, **kwargs):
        spawned.append(real(*args, **kwargs))
        return spawned[-1]

    monkeypatch.setattr(subprocess, "Popen", record)
    t0 = time.monotonic()
    code = distributed.launch_local(
        2,
        ["sourmash", str(tmp_path / "genomes_{rank}"), "-d", str(tmp_path / "ani_{rank}.db"),
         "--create-db", "--cache", str(tmp_path / "cache")],
        timeout=20, quiet=True,
    )  # fmt: skip
    assert code == 124
    assert time.monotonic() - t0 < 60
    assert len(spawned) == 2
    assert all(proc.returncode is not None for proc in spawned)


def test_launch_needs_a_command() -> None:
    result = CliRunner().invoke(torch_app, ["launch", "-n", "2"])
    assert result.exit_code != 0
    assert "No command given to launch" in result.output
