"""The port's ``import-comparisons`` against the JAX package's.

The counterpart of ``tests/test_json_transport.py``, case for case. Each
case builds the same store and the same JSON files for each package in
turn, at the same paths, with that package's own ``Database``, and runs
that package's CLI on them. The two must agree on the exit code, on the
message text (log time stamps and line breaks aside) and on the
``configurations`` and ``comparisons`` tables afterwards; the port must
also meet the JAX test's own assertions. Import has to refuse anything
that could silently corrupt a merge: unknown configurations, incomplete
records, malformed payloads.
"""

from __future__ import annotations

import json
import re
import shutil
import sqlite3
from pathlib import Path
from typing import Callable, NamedTuple

from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu.db import Database as JaxDatabase
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database as TorchDatabase

PACKAGES = {"jax": (jax_app, JaxDatabase), "torch": (torch_app, TorchDatabase)}
CONFIG = {
    "method": "guessing",
    "program": "guestimate",
    "version": "0.1.2beta3",
    "fragsize": 100,
    "kmersize": 51,
}
UNAME = {"system": "Linux", "release": "6.0", "machine": "x86_64"}
HASH_A = "689d3fd6881db36b5e08329cf23cecdd"
HASH_B = "78975d5144a1cd12e98898d573cf6536"


class Outcome(NamedTuple):
    exit_code: int
    text: str
    tables: dict[str, list[tuple]]


def _text(output: str) -> str:
    """The CLI's output without rich's time stamps and line breaks."""
    return " ".join(re.sub(r"\[\d\d/\d\d/\d\d \d\d:\d\d:\d\d\]", " ", output).split())


def _tables(db: Path) -> dict[str, list[tuple]]:
    if not db.is_file():
        return {}
    with sqlite3.connect(db) as conn:
        return {
            table: conn.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()  # noqa: S608
            for table in ("configurations", "comparisons")
        }


def _seeded_db(work: Path, database, *, configs: bool = True, genomes: bool = True) -> Path:
    db_path = work / "import.sqlite"
    with database(db_path, create=True) as db:
        if configs:
            db.get_or_create_configuration(
                CONFIG["method"],
                CONFIG["program"],
                CONFIG["version"],
                fragsize=CONFIG["fragsize"],
                kmersize=CONFIG["kmersize"],
            )
        if genomes:
            db.add_genome(HASH_A, "a.fas", 10, "a")
            db.add_genome(HASH_B, "b.fna", 10, "b")
    return db_path


def _payload(comparisons, config=CONFIG, uname=UNAME) -> str:
    return json.dumps({"configuration": config, "uname": uname, "comparisons": comparisons})


def _both(tmp_path: Path, build: Callable[[Path, type], tuple[Path, list[Path]]]) -> Outcome:
    """Run ``import-comparisons`` of each package on what ``build(work,
    Database)`` makes; assert both agree and return the port's outcome."""
    outcomes = {}
    work = tmp_path / "work"
    for tag, (app, database) in PACKAGES.items():
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        db, files = build(work, database)
        result = CliRunner().invoke(
            app,
            ["import-comparisons", "-d", str(db), *map(str, files)],
            catch_exceptions=False,
            env={"COLUMNS": "400"},
        )
        outcomes[tag] = Outcome(result.exit_code, _text(result.output), _tables(db))
    assert outcomes["torch"] == outcomes["jax"]
    return outcomes["torch"]


def _one_file(content: str | None, **seed) -> Callable[[Path, type], tuple[Path, list[Path]]]:
    """A store seeded as ``_seeded_db`` with ``seed``, and one JSON file
    holding ``content`` (an empty file for None)."""

    def build(work: Path, database) -> tuple[Path, list[Path]]:
        db = _seeded_db(work, database, **seed)
        j = work / "x.json"
        j.write_text(content or "")
        return db, [j]

    return build


def test_missing_database_errors(tmp_path) -> None:
    def build(work: Path, _database) -> tuple[Path, list[Path]]:
        j = work / "x.json"
        j.touch()
        return work / "nope.sqlite", [j]

    assert _both(tmp_path, build).exit_code != 0


def test_database_without_configurations_errors(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file(None, configs=False, genomes=False))
    assert outcome.exit_code != 0
    assert "does not contain any configurations" in outcome.text


def test_database_without_genomes_errors(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file(None, genomes=False))
    assert outcome.exit_code != 0
    assert "does not contain any genomes" in outcome.text


def test_empty_file_warns_and_continues(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file(None))
    assert outcome.exit_code == 0, outcome.text
    assert "Imported 0 comparisons" in outcome.text


def test_invalid_json_errors(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file("["))
    assert outcome.exit_code != 0
    assert "invalid" in outcome.text


def test_unexpected_structure_errors(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file("[]"))
    assert outcome.exit_code != 0
    assert "does not use the expected structure" in outcome.text


def test_unknown_configuration_errors(tmp_path) -> None:
    """A configuration the database has never seen must NOT be created."""
    config = {"method": "ANIm", "program": "nucmer", "version": "3.1"}
    outcome = _both(tmp_path, _one_file(_payload([], config=config)))
    assert outcome.exit_code != 0
    assert "configuration not in database" in outcome.text
    assert len(outcome.tables["configurations"]) == 1  # nothing new created


def test_incomplete_uname_errors(tmp_path) -> None:
    uname = {"system": "Linux", "release": "6.0"}
    outcome = _both(tmp_path, _one_file(_payload([], uname=uname)))
    assert outcome.exit_code != 0
    assert "uname incomplete" in outcome.text


def test_incomplete_configuration_errors(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file(_payload([], config={"method": "guessing"})))
    assert outcome.exit_code != 0
    assert "configuration incomplete" in outcome.text


def test_no_comparisons_is_warning_only(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file(_payload([])))
    assert outcome.exit_code == 0, outcome.text


def test_incomplete_comparison_errors(tmp_path) -> None:
    outcome = _both(tmp_path, _one_file(_payload([{"query_hash": HASH_A, "identity": 0.99}])))
    assert outcome.exit_code != 0
    assert "comparison(s) incomplete" in outcome.text


def test_valid_import_inserts(tmp_path) -> None:
    row = {"query_hash": HASH_A, "subject_hash": HASH_B, "identity": 0.99}
    outcome = _both(tmp_path, _one_file(_payload([row])))
    assert outcome.exit_code == 0, outcome.text
    assert "Imported 1 comparisons" in outcome.text
    with TorchDatabase(tmp_path / "work" / "import.sqlite") as db:
        stored = db.conn.execute("SELECT identity, uname_system FROM comparisons").fetchone()
    assert stored["identity"] == 0.99
    assert stored["uname_system"] == "Linux"


def test_multiple_files_one_bad_stops(tmp_path) -> None:
    """A bad file aborts the command; earlier good files are kept
    (idempotence makes re-running after a fix safe)."""

    def build(work: Path, database) -> tuple[Path, list[Path]]:
        db = _seeded_db(work, database)
        good = work / "good.json"
        good.write_text(
            _payload([{"query_hash": HASH_A, "subject_hash": HASH_A, "identity": 1.0}])
        )
        bad = work / "bad.json"
        bad.write_text("[")
        return db, [good, bad]

    outcome = _both(tmp_path, build)
    assert outcome.exit_code != 0
    assert len(outcome.tables["comparisons"]) == 1
