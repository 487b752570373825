"""The port's CLI against the JAX package's CLI, end to end on the CPU.

Both CLIs run on the same synthetic genomes into separate databases;
their ``export-run`` tables must be equal (matrices with both axes
sorted: integer matrices exact, floats equal). A run started by one
package resumes under the other, and the port runs with both ``jax`` and
the JAX package refused by an import hook.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu.db import Database
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.synthetic import write_genome_dir

REPO = Path(__file__).resolve().parents[1]
APPS = {"jax": jax_app, "torch": torch_app}
METHODS = {"anim": "ANIm", "dnadiff": "dnadiff", "anib": "ANIb", "sourmash": "sourmash"}


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory) -> Path:
    directory = tmp_path_factory.mktemp("genomes")
    write_genome_dir(directory, 40_000, [0.02, 0.08, 0.15], seed=7)
    return directory


def _run_cli(app, args: list[str]) -> str:
    result = CliRunner().invoke(app, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.output


def _read(path: Path) -> pd.DataFrame:
    frame = pd.read_csv(path, sep="\t", index_col=0)
    frame.index = frame.index.map(str)
    return frame.sort_index(axis=0).sort_index(axis=1)


@pytest.mark.parametrize("command", sorted(METHODS))
def test_cli_export_matches_jax(command: str, genome_dir: Path, tmp_path: Path) -> None:
    outdirs = {}
    for tag, app in APPS.items():
        db = tmp_path / f"{tag}.db"
        _run_cli(app, [command, str(genome_dir), "-d", str(db), "--create-db",
                       "--cache", str(tmp_path / f"cache_{tag}")])  # fmt: skip
        outdirs[tag] = tmp_path / f"out_{tag}"
        _run_cli(app, ["export-run", "-d", str(db), "-o", str(outdirs[tag])])
    method = METHODS[command]
    names = sorted(p.name for p in outdirs["jax"].glob("*.tsv"))
    assert names == sorted(p.name for p in outdirs["torch"].glob("*.tsv"))
    for name in ("aln_lengths", "sim_errors", "identity", "query_cov", "hadamard", "tANI"):
        assert f"{method}_{name}.tsv" in names, name
    for name in names:
        got, expected = (_read(outdirs[tag] / name) for tag in ("torch", "jax"))
        if name.endswith("_run_1.tsv"):  # long form, rows in completion order
            got, expected = got.sort_values(list(got.columns)), expected.sort_values(
                list(expected.columns)
            )
        # exact: integers equal, floats equal (NaN where no alignment)
        pd.testing.assert_frame_equal(got, expected, check_exact=True, obj=name)
    identity = _read(outdirs["torch"] / f"{method}_identity.tsv").to_numpy()
    assert np.isfinite(identity.diagonal()).all()


@pytest.mark.parametrize(
    ("command", "first", "second"),
    [
        pytest.param("anim", "torch", "jax", id="torch-jax"),
        pytest.param("anim", "jax", "torch", id="jax-torch"),
        pytest.param("sourmash", "torch", "jax", id="sourmash-torch-jax"),
        pytest.param("sourmash", "jax", "torch", id="sourmash-jax-torch"),
    ],
)
def test_resume_across_packages(
    command: str, first: str, second: str, genome_dir: Path, tmp_path: Path
) -> None:
    """A partial ANIm or sourmash run of one package completes under the
    other's ``resume`` (same configuration rows, same version check)."""
    db = tmp_path / "ani.db"
    cache = ["--cache", str(tmp_path / "cache")]
    _run_cli(APPS[first], [command, str(genome_dir), "-d", str(db), "--create-db", *cache])
    with Database(db) as store:
        before = {
            (r["query_hash"], r["subject_hash"]): r["identity"]
            for r in store.load_run().comparisons()
        }
        store.execute_with_retries(
            "DELETE FROM comparisons WHERE comparison_id IN"
            " (SELECT comparison_id FROM comparisons LIMIT 4)"
        )
        store.execute_with_retries("UPDATE runs SET status='Worker interrupted'")
    _run_cli(APPS[second], ["resume", "-d", str(db), *cache])
    with Database(db) as store:
        run = store.load_run()
        assert run.comparisons_count() == 9
        assert run.status == "Done"
        after = {
            (r["query_hash"], r["subject_hash"]): r["identity"]
            for r in run.comparisons()
        }
    assert after == before


def test_port_cli_commands_and_unknown_method_resume(genome_dir: Path, tmp_path: Path) -> None:
    """The port has every command of the JAX package, ``launch`` included;
    the report, host-method and ``launch`` commands are its own copies with
    the JAX package's options, and a run of a method that does not exist
    (a made-up name) cannot be resumed: both CLIs refuse it with the same
    message."""
    assert set(torch_app.commands) == set(jax_app.commands)
    assert "launch" in torch_app.commands
    for name in sorted(set(torch_app.commands) - {"anim", "dnadiff", "anib", "sourmash", "resume"}):
        mine, theirs = torch_app.commands[name], jax_app.commands[name]
        assert mine is not theirs
        assert mine.callback.__module__ == "pyani_plus_tpu_torch.cli.main"
        assert [(o.name, o.opts, o.default) for o in mine.params] == [
            (o.name, o.opts, o.default) for o in theirs.params
        ], name
    messages = {}
    for tag, app in APPS.items():
        db = tmp_path / f"skani_{tag}.db"
        _run_cli(app, ["skani", str(genome_dir), "-d", str(db), "--create-db",
                       "--cache", str(tmp_path / "cache")])  # fmt: skip
        with Database(db) as store:
            store.execute_with_retries("UPDATE configurations SET method='no-such-method'")
            assert store.load_run().configuration.method == "no-such-method"
        with pytest.raises(ValueError, match=r"^Unknown method 'no-such-method'; known: ") as err:
            CliRunner().invoke(
                app, ["resume", "-d", str(db), "--cache", str(tmp_path / "cache")],
                catch_exceptions=False,
            )
        messages[tag] = str(err.value)
    assert messages["torch"] == messages["jax"]


# Refuses any import of jax or of the JAX package, wherever it comes from.
IMPORT_HOOK = """
import sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"):
            raise ImportError("refused in this test: " + name)
sys.meta_path.insert(0, _Refuse())
"""


def test_port_runs_without_jax(tmp_path: Path) -> None:
    """A CPU ANIm pair, a CPU ANIb pair and a sourmash pair through the
    port, with the batched (plain PyTorch) extension and Smith-Waterman
    paths and the device Gram forced, import neither jax nor anything of
    the JAX package: an import hook refuses both. A subprocess, because
    the test process itself imports them (tests/conftest.py)."""
    fastas = write_genome_dir(tmp_path, 30_000, [0.05, 0.12], seed=3)
    code = IMPORT_HOOK + f"""
import json
import pyani_plus_tpu_torch.cli.main
import pyani_plus_tpu_torch.parallel.runner
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.methods import anib, anim
from pyani_plus_tpu_torch.ops.minhash import containment_ani, sketch_genome
from pyani_plus_tpu_torch.ops.seeds import SeedIndex
batches, sw_batches = [], []
real = anim.batch_extend_submit
anim.batch_extend_submit = lambda tasks, device, **kw: batches.append(len(tasks)) or real(tasks, device, **kw)
real_sw = anib.batch_sw_best_submit
anib.batch_sw_best_submit = lambda tasks, devices: sw_batches.append(len(tasks)) or real_sw(tasks, devices)
q, s = (load_genome(p) for p in {[str(p) for p in fastas]!r})
row = anim.compute_pair(q, s)
anib_row = anib.compute_pair(q, s, [SeedIndex(r.codes) for r in s.records], 1020)
sm_identity, _ = containment_ani([sketch_genome(g, 21, 100) for g in (q, s)], use_device=True)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"))
print(json.dumps({{"loaded": loaded, "identity": row["identity"], "batches": batches,
                  "anib_identity": anib_row[0], "sw_batches": sw_batches,
                  "sourmash_identity": float(sm_identity[0, 1])}}))
"""
    env = {
        **os.environ,
        "PYANI_TPU_EXTEND_BATCH_MIN": "1",
        "PYANI_TPU_ANIB_DEVICE": "1",
        "OMP_NUM_THREADS": "1",  # row-serial small tensors
        "PYTHONPATH": os.pathsep.join(
            [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]
        ),
    }
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=300, check=False,
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert sum(result["batches"]) > 0, result
    assert 0.7 < result["identity"] < 1.0
    assert sum(result["sw_batches"]) > 0, result
    assert 0.7 < result["anib_identity"] < 1.0
    assert 0.5 < result["sourmash_identity"] < 1.0


def test_versions_agree() -> None:
    """Configuration rows and the resume check compare the version
    string, so the two packages must state the same one."""
    import pyani_plus_tpu
    import pyani_plus_tpu_torch

    assert pyani_plus_tpu_torch.__version__ == pyani_plus_tpu.__version__
    assert pyani_plus_tpu_torch.FASTA_EXTENSIONS == pyani_plus_tpu.FASTA_EXTENSIONS
    assert pyani_plus_tpu_torch.GRAPHICS_FORMATS == pyani_plus_tpu.GRAPHICS_FORMATS
