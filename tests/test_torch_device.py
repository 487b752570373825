"""The port's device choice: the card, or the CPU when the caller asks.

``PYANI_TPU_TORCH_DEVICE`` takes ``cuda`` (the default) or ``cpu`` and is
read in ``backend.py`` alone. With the card requested and none found,
every compute path refuses with a message that names the variable; with
the CPU requested, no path touches a card. "No card" is made here by
patching ``torch.cuda.is_available`` or by running a subprocess under
``CUDA_VISIBLE_DEVICES=""``, so that every test holds on a machine with
cards too. Checked:

- resolution: the refusal, the CPU request, bad values, the capability
  check, ``on_card``, and a mesh of several cards that the CPU request
  turns off;
- dispatch: ANIm's extensions, ANIb's scorer, sourmash's Gram and
  sketch, the runner, a group worker and the driver entry follow the
  request, and the JAX package's overrides keep their meaning;
- the CLI: the four methods with work for the card refuse without a card
  and without a request, store no comparison, and under ``launch -n 2``
  fail in well under a minute;
- statically: no module of the port outside ``backend.py`` decides by
  ``torch.cuda.is_available()`` or ``probe().cuda``.
"""

from __future__ import annotations

import ast
import logging
import os
import sqlite3
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from pyani_plus_tpu_torch import backend, graft_entry
from pyani_plus_tpu_torch.cli import main as cli
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.methods import CARD_METHODS, anib, anim, method_names
from pyani_plus_tpu_torch.ops import minhash
from pyani_plus_tpu_torch.parallel import distributed, runner, tiles
from pyani_plus_tpu_torch.synthetic import gram_fuzz_sets, write_genome_dir

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pyani_plus_tpu_torch"
REFUSAL = r"no CUDA device was found; .*set PYANI_TPU_TORCH_DEVICE=cpu to run on the CPU"
CLI_COMMANDS = sorted(name.lower() for name in CARD_METHODS)


@pytest.fixture(autouse=True)
def fresh_probe():
    """The probe's report is cached per process: none is left behind by a
    test that patches CUDA."""
    backend.probe.cache_clear()
    yield
    backend.probe.cache_clear()


@pytest.fixture
def no_card(monkeypatch) -> None:
    """The card requested (the variable unset), and no card found."""
    monkeypatch.delenv(backend.ENV_DEVICE, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _fake_cards(monkeypatch, count: int, capability: tuple[int, int] = (9, 0)) -> None:
    """``count`` cards of ``capability`` as torch reports them; none is
    touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device: capability)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "a fake card")


# ------------------------------------------------------------ resolution


def test_no_card_and_no_request_refuses(no_card) -> None:
    assert backend.requested_device() == "cuda"
    assert backend.cards() == []
    for resolve in (backend.kernel_device, backend.on_card, backend.kernel_devices):
        with pytest.raises(RuntimeError, match=REFUSAL):
            resolve()


def test_cpu_request_gives_the_cpu(monkeypatch) -> None:
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert backend.kernel_device() == torch.device("cpu")
    assert backend.kernel_devices() == [torch.device("cpu")]
    assert backend.on_card() is False
    _fake_cards(monkeypatch, 4)  # cards present do not change the answer
    assert backend.kernel_device() == torch.device("cpu")
    assert backend.cards() == []
    assert backend.on_card() is False


@pytest.mark.parametrize("value", ["gpu", "CPU", "", "cuda:0"])
def test_another_value_raises(monkeypatch, value: str) -> None:
    monkeypatch.setenv(backend.ENV_DEVICE, value)
    for resolve in (backend.requested_device, backend.kernel_device, backend.cards):
        with pytest.raises(ValueError, match=r"PYANI_TPU_TORCH_DEVICE=.*'cuda' .*'cpu'"):
            resolve()


def test_card_requested_and_present(monkeypatch) -> None:
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    _fake_cards(monkeypatch, 2)
    assert backend.kernel_device() == torch.device("cuda", 0)
    assert backend.on_card() is True
    assert backend.kernel_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_a_card_that_is_not_sm_90_raises_when_resolved(monkeypatch) -> None:
    monkeypatch.delenv(backend.ENV_DEVICE, raising=False)
    _fake_cards(monkeypatch, 1, capability=(8, 0))
    for resolve in (backend.kernel_device, backend.on_card, backend.kernel_devices):
        with pytest.raises(RuntimeError, match=r"built for sm_90a; this device is a fake card "
                                               r"with capability \(8, 0\)"):
            resolve()
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert backend.kernel_device() == torch.device("cpu")


def test_the_request_is_read_when_needed(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert backend.kernel_device().type == "cpu"
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    with pytest.raises(RuntimeError, match=REFUSAL):
        backend.kernel_device()


def test_cpu_request_turns_off_the_mesh_of_several_cards(monkeypatch) -> None:
    monkeypatch.setattr(tiles, "_PAIR_MESH", None)
    monkeypatch.setattr(tiles, "_DEFAULT_MESH_CACHE", {})
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.delenv("PYANI_TPU_MESH", raising=False)
    _fake_cards(monkeypatch, 4)
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    assert tiles.default_pair_mesh().shape == (2, 2)
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert tiles.default_pair_mesh() is None
    assert [d.type for d in tiles.make_mesh().devices.flat] == ["cpu"]


def test_a_worker_with_the_cpu_requested_touches_no_card(monkeypatch) -> None:
    joined: list[dict] = []
    monkeypatch.setattr(distributed, "_initialized", False)
    _fake_cards(monkeypatch, 4)

    def touched(*args, **kwargs):
        raise AssertionError("a card was made current")

    monkeypatch.setattr(torch.cuda, "set_device", touched)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kwargs: joined.append(kwargs))  # fmt: skip
    monkeypatch.setattr(distributed, "atexit", types.SimpleNamespace(register=lambda fn: None))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: joined[-1]["rank"])
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: joined[-1]["world_size"])
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:29517")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "1")
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert distributed.maybe_initialize() == (1, 2)
    assert backend.kernel_device() == torch.device("cpu")


# ------------------------------------------------------------ dispatch


def _tasks(seed: int, count: int, length: int) -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.integers(0, 4, length).astype(np.uint8)
        b = a.copy()
        mut = rng.random(length) < 0.05
        b[mut] = (b[mut] + 1) % 4
        out.append((a, b))
    return out


def test_methods_refuse_without_a_card(no_card, monkeypatch) -> None:
    """Each dispatch site of the methods resolves the device: without the
    card nothing runs on the CPU in its place, whatever the JAX package's
    overrides say."""
    monkeypatch.delenv("PYANI_TPU_ANIB_DEVICE", raising=False)
    monkeypatch.delenv("PYANI_TPU_EXTEND_BATCH_MIN", raising=False)
    with pytest.raises(RuntimeError, match=REFUSAL):
        anim._default_ext_batch_min()
    with pytest.raises(RuntimeError, match=REFUSAL):
        anib.use_device()
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", "1")  # the batched path
    with pytest.raises(RuntimeError, match=REFUSAL):
        anim._run_extensions(_tasks(1, 3, 120))
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")  # the batched scorer
    assert anib.use_device() is True
    with pytest.raises(RuntimeError, match=REFUSAL):
        anib._score_device_submit(_tasks(2, 3, 80))
    sketches = gram_fuzz_sets(seed=5, n=8)["pool"]
    with pytest.raises(RuntimeError, match=REFUSAL):
        minhash.intersection_matrix_device(sketches)
    with pytest.raises(RuntimeError, match=REFUSAL):
        minhash.containment_ani(sketches, use_device=True)
    # below the JAX package's size threshold sourmash's counts stay on the
    # host: a size choice, not a device choice
    identity, _ = minhash.containment_ani(sketches)
    assert identity.shape == (8, 8)


def test_methods_run_on_the_cpu_when_asked(monkeypatch, tmp_path: Path) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    monkeypatch.delenv("PYANI_TPU_ANIB_DEVICE", raising=False)
    monkeypatch.delenv("PYANI_TPU_EXTEND_BATCH_MIN", raising=False)
    assert anim._default_ext_batch_min() == anim.EXT_BATCH_MIN
    assert anib.use_device() is False
    tasks = _tasks(3, 3, 120)
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", "1")  # the plain version on the CPU
    batched = anim._run_extensions(tasks)
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", str(1 << 40))  # the native host kernel
    assert batched == anim._run_extensions(tasks)
    write_genome_dir(tmp_path, 2_000, [0.05], seed=3)
    genome = load_genome(sorted(tmp_path.iterdir())[0])
    got = minhash.sketch_genomes_device([genome], 21, 10)[0]
    assert np.array_equal(got.hashes, minhash.sketch_genome(genome, 21, 10).hashes)


@pytest.mark.parametrize("method", method_names())
def test_runner_resolves_the_device_of_card_methods_only(no_card, method: str,
                                                         tmp_path: Path) -> None:  # fmt: skip
    """A method with work for the card refuses before anything is stored;
    a host-only method needs no device."""
    logger = logging.getLogger("test_torch_device")
    if method in CARD_METHODS:
        with pytest.raises(SystemExit, match=f"{method}: {REFUSAL}"):
            runner.require_device(logger, method)
        write_genome_dir(tmp_path / "genomes", 2_000, [0.05], seed=4)
        with pytest.raises(SystemExit, match=REFUSAL):
            runner.start_and_run_method(logger, tmp_path / "run.db", tmp_path / "genomes",
                                        method, create_db=True)  # fmt: skip
        assert not (tmp_path / "run.db").exists()
    else:
        assert runner.require_device(logger, method) is None


def test_driver_entry_follows_the_request(no_card, monkeypatch, capsys) -> None:
    """``entry()`` refuses without a card and gives the CPU when asked;
    the dry run over a mesh of the CPU asks for the CPU for its runner
    step itself, and gives the request back."""
    with pytest.raises(RuntimeError, match="device='cpu' or set PYANI_TPU_TORCH_DEVICE=cpu"):
        graft_entry.entry()
    record = graft_entry.dryrun_multichip(2, devices=[torch.device("cpu")] * 2)
    assert record["merged_comparisons"] == 9
    assert backend.ENV_DEVICE not in os.environ
    assert "dryrun_multichip OK" in capsys.readouterr().out
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert graft_entry.entry()[1][0].device.type == "cpu"


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory) -> Path:
    directory = tmp_path_factory.mktemp("genomes")
    write_genome_dir(directory, 3_000, [0.02, 0.08], seed=9)
    return directory


def _cli_env() -> dict[str, str]:
    """This session's environment without the request and with no card
    visible."""
    env = {key: value for key, value in os.environ.items() if key != backend.ENV_DEVICE}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])
    return env


def _comparisons(db: Path) -> int:
    if not db.exists():
        return 0
    with sqlite3.connect(db) as conn:
        tables = {row[0] for row in conn.execute("SELECT name FROM sqlite_master")}
        if "comparisons" not in tables:
            return 0
        return conn.execute("SELECT COUNT(*) FROM comparisons").fetchone()[0]


@pytest.mark.parametrize("command", CLI_COMMANDS)
def test_cli_without_a_card_or_a_request_refuses(command: str, genome_dir: Path,
                                                 tmp_path: Path) -> None:  # fmt: skip
    db = tmp_path / "run.db"
    proc = subprocess.run(
        [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main", command, str(genome_dir),
         "-d", str(db), "--create-db", "--cache", str(tmp_path / "cache")],
        capture_output=True, text=True, env=_cli_env(), timeout=120, check=False,
    )  # fmt: skip
    assert proc.returncode != 0, proc.stdout
    assert "PYANI_TPU_TORCH_DEVICE=cpu" in proc.stderr, proc.stderr
    assert "no CUDA device was found" in proc.stderr
    assert _comparisons(db) == 0


def test_launch_without_a_card_or_a_request_fails_early(genome_dir: Path, tmp_path: Path) -> None:
    """Each worker refuses before it joins the group: no rank is left
    waiting for another, so the group ends at once, not at a timeout."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main", "launch", "-n", "2", "--",
         "anim", str(genome_dir), "-d", str(tmp_path / "run_{rank}.db"), "--create-db"],
        capture_output=True, text=True, env=_cli_env(), timeout=120, check=False,
    )  # fmt: skip
    seconds = time.monotonic() - t0
    assert proc.returncode not in (0, 124), proc.stderr
    assert seconds < 60, seconds
    assert "PYANI_TPU_TORCH_DEVICE=cpu" in proc.stderr, proc.stderr
    assert all(_comparisons(tmp_path / f"run_{rank}.db") == 0 for rank in range(2))


@pytest.mark.parametrize("command", [*CLI_COMMANDS, "fastani"])
def test_a_worker_refuses_before_it_joins(no_card, monkeypatch, command: str,
                                          genome_dir: Path, tmp_path: Path) -> None:  # fmt: skip
    """In a group, a method with work for the card resolves its device
    before the CLI joins the group: a worker without its card never
    leaves a peer waiting for it. A host-only method joins."""
    joined: list[bool] = []
    monkeypatch.setattr(distributed, "maybe_initialize", lambda *args: joined.append(True))
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:29517")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "1")
    monkeypatch.setattr(cli, "start_and_run_method", lambda *args, **kwargs: 1)
    result = CliRunner().invoke(cli.app, [command, str(genome_dir), "-d", str(tmp_path / "x.db"),
                                            "--create-db"])  # fmt: skip
    if command == "fastani":
        assert result.exit_code == 0, result.output
        assert joined == [True]
    else:
        assert result.exit_code != 0
        assert "PYANI_TPU_TORCH_DEVICE=cpu" in str(result.exception)
        assert joined == []


def test_resume_without_a_card_or_a_request_refuses(genome_dir: Path, tmp_path: Path,
                                                    monkeypatch) -> None:  # fmt: skip
    """``resume`` learns its method from the store: the runner resolves
    the device, alone and under ``launch -n 2`` before a worker joins."""
    db = tmp_path / "run.db"
    with monkeypatch.context() as patch:
        patch.setenv(backend.ENV_DEVICE, "cpu")
        patch.setenv("PYANI_TPU_PROCESS_COUNT", "2")  # leave the run partial
        runner.start_and_run_method(logging.getLogger("test_torch_device"), db, genome_dir,
                                    "ANIm", create_db=True)  # fmt: skip
    partial = _comparisons(db)
    assert 0 < partial < 4
    for prefix in ([], ["launch", "-n", "2", "--"]):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main", *prefix, "resume",
             "-d", str(db)],
            capture_output=True, text=True, env=_cli_env(), timeout=120, check=False,
        )  # fmt: skip
        assert proc.returncode not in (0, 124), proc.stderr
        assert time.monotonic() - t0 < 60
        assert "PYANI_TPU_TORCH_DEVICE=cpu" in proc.stderr, proc.stderr
        assert _comparisons(db) == partial


# ------------------------------------------------------------ statically

SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if p != PACKAGE / "backend.py")


def _device_decisions(text: str) -> list[str]:
    """Calls of ``torch.cuda.is_available()`` and reads of ``.cuda`` on a
    call of ``probe()``."""
    found = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Attribute) and ast.unparse(node).endswith("cuda.is_available"):
            found.append(ast.unparse(node))
        elif (isinstance(node, ast.Attribute) and node.attr == "cuda"
              and isinstance(node.value, ast.Call) and "probe" in ast.unparse(node.value.func)):  # fmt: skip
            found.append(ast.unparse(node))
    return found


def test_no_module_but_the_backend_decides_the_device() -> None:
    assert len(SOURCES) > 30
    assert PACKAGE / "parallel" / "tiles.py" in SOURCES
    assert _device_decisions("import torch\nif torch.cuda.is_available(): pass") != []
    assert _device_decisions("x = backend.probe().cuda") != []
    offenders = {
        str(path.relative_to(REPO)): found
        for path in SOURCES
        if (found := _device_decisions(path.read_text()))
    }
    assert offenders == {}
    assert _device_decisions((PACKAGE / "backend.py").read_text()) != []
