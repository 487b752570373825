"""Content-addressed result store: genomes, configurations, runs, comparisons.

Same data model and semantics as the reference's SQLAlchemy ORM
(pyani_plus/db_orm.py), built directly on stdlib ``sqlite3``:

- ``genomes``        PK = content MD5 (db_orm.py:103-145)
- ``configurations`` unique (method, program, version, fragsize, mode,
                     kmersize, minmatch, extra) (db_orm.py:148-215)
- ``comparisons``    unique (query_hash, subject_hash, configuration_id);
                     inserts use INSERT OR IGNORE so merges are idempotent
                     and resumable (db_orm.py:218-299, :1044-1114)
- ``runs``           per-invocation row caching the five N x N matrices as
                     JSON "split" DataFrames (db_orm.py:302-343, :393-466)
- ``runs_genomes``   run <-> genome association with the as-given filename

Comparisons are keyed by genome *content* MD5 + configuration, so results
are shared between runs and never recomputed -- the DB is the checkpoint
(SURVEY.md section 5).
"""

from __future__ import annotations

import datetime
import logging
import random
import sqlite3
import time
from dataclasses import dataclass
from io import StringIO
from math import log as math_log
from math import nan
from pathlib import Path
from typing import Any

import numpy as np

from pyani_plus_tpu_torch.utils import filename_stem

_SCHEMA = """
CREATE TABLE IF NOT EXISTS genomes (
    genome_hash TEXT PRIMARY KEY,
    path TEXT NOT NULL,
    length INTEGER NOT NULL,
    description TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS configurations (
    configuration_id INTEGER PRIMARY KEY AUTOINCREMENT,
    method TEXT NOT NULL,
    program TEXT NOT NULL,
    version TEXT NOT NULL,
    fragsize INTEGER,
    mode TEXT,
    kmersize INTEGER,
    minmatch REAL,
    extra TEXT,
    UNIQUE (method, program, version, fragsize, mode, kmersize, minmatch, extra)
);
CREATE TABLE IF NOT EXISTS comparisons (
    comparison_id INTEGER PRIMARY KEY AUTOINCREMENT,
    configuration_id INTEGER NOT NULL REFERENCES configurations (configuration_id),
    query_hash TEXT NOT NULL REFERENCES genomes (genome_hash),
    subject_hash TEXT NOT NULL REFERENCES genomes (genome_hash),
    identity REAL,
    aln_length INTEGER,
    sim_errors INTEGER,
    cov_query REAL,
    cov_subject REAL,
    uname_system TEXT NOT NULL DEFAULT '',
    uname_release TEXT NOT NULL DEFAULT '',
    uname_machine TEXT NOT NULL DEFAULT '',
    UNIQUE (query_hash, subject_hash, configuration_id)
);
CREATE INDEX IF NOT EXISTS idx_comparisons_config
    ON comparisons (configuration_id, subject_hash);
CREATE TABLE IF NOT EXISTS runs (
    run_id INTEGER PRIMARY KEY AUTOINCREMENT,
    configuration_id INTEGER NOT NULL REFERENCES configurations (configuration_id),
    cmdline TEXT NOT NULL,
    fasta_directory TEXT NOT NULL,
    date TEXT NOT NULL,
    status TEXT NOT NULL,
    name TEXT NOT NULL,
    df_identity TEXT,
    df_cov_query TEXT,
    df_aln_length TEXT,
    df_sim_errors TEXT,
    df_hadamard TEXT
);
CREATE TABLE IF NOT EXISTS runs_genomes (
    run_id INTEGER NOT NULL REFERENCES runs (run_id),
    genome_hash TEXT NOT NULL REFERENCES genomes (genome_hash),
    fasta_filename TEXT NOT NULL,
    PRIMARY KEY (run_id, genome_hash)
);
"""

_ATTEMPTS = 3  # retry/backoff like db_orm.py:660-702 (NFS-locked SQLite)


@dataclass
class Configuration:
    configuration_id: int
    method: str
    program: str
    version: str
    fragsize: int | None
    mode: str | None
    kmersize: int | None
    minmatch: float | None
    extra: str | None


@dataclass
class ComparisonRow:
    query_hash: str
    subject_hash: str
    identity: float | None
    aln_length: int | None
    sim_errors: int | None
    cov_query: float | None
    cov_subject: float | None


class Run:
    """A run row plus its genome associations and cached matrices."""

    def __init__(self, db: Database, row: sqlite3.Row) -> None:
        self._db = db
        self.run_id: int = row["run_id"]
        self.configuration_id: int = row["configuration_id"]
        self.cmdline: str = row["cmdline"]
        self.fasta_directory: str = row["fasta_directory"]
        self.date: str = row["date"]
        self.status: str = row["status"]
        self.name: str = row["name"]
        self._df = {
            key: row[f"df_{key}"]
            for key in ("identity", "cov_query", "aln_length", "sim_errors", "hadamard")
        }

    # -- associations ------------------------------------------------------

    @property
    def configuration(self) -> Configuration:
        return self._db.get_configuration(self.configuration_id)

    @property
    def genome_hashes(self) -> list[str]:
        """Sorted genome hashes in this run (matrix index order)."""
        cur = self._db.conn.execute(
            "SELECT genome_hash FROM runs_genomes WHERE run_id=? ORDER BY genome_hash",
            (self.run_id,),
        )
        return [r[0] for r in cur]

    @property
    def hash_to_filename(self) -> dict[str, str]:
        cur = self._db.conn.execute(
            "SELECT genome_hash, fasta_filename FROM runs_genomes WHERE run_id=?",
            (self.run_id,),
        )
        return dict(cur.fetchall())

    def comparisons(self) -> list[sqlite3.Row]:
        """All comparisons for this run's configuration and genome set."""
        return self._db.conn.execute(
            """
            SELECT c.* FROM comparisons AS c
            JOIN runs_genomes AS rq
              ON c.query_hash = rq.genome_hash AND rq.run_id = :run
            JOIN runs_genomes AS rs
              ON c.subject_hash = rs.genome_hash AND rs.run_id = :run
            WHERE c.configuration_id = :config
            """,
            {"run": self.run_id, "config": self.configuration_id},
        ).fetchall()

    def comparisons_count(self) -> int:
        return self._db.conn.execute(
            """
            SELECT COUNT(*) FROM comparisons AS c
            JOIN runs_genomes AS rq
              ON c.query_hash = rq.genome_hash AND rq.run_id = :run
            JOIN runs_genomes AS rs
              ON c.subject_hash = rs.genome_hash AND rs.run_id = :run
            WHERE c.configuration_id = :config
            """,
            {"run": self.run_id, "config": self.configuration_id},
        ).fetchone()[0]

    def comparison_status_counts(self) -> tuple[int, int]:
        """(done, null) comparison counts, computed in SQL.

        The reference counts per-run Done/Null in the database rather
        than materialising every row in Python (public_cli.py:845-882);
        at the 1000-genome design point a run holds 10^6 comparison rows
        and the Python loop is the difference between list-runs being
        instant or taking seconds per run.
        """
        done, null = self._db.conn.execute(
            """
            SELECT
              COALESCE(SUM(c.identity IS NOT NULL), 0),
              COALESCE(SUM(c.identity IS NULL), 0)
            FROM comparisons AS c
            JOIN runs_genomes AS rq
              ON c.query_hash = rq.genome_hash AND rq.run_id = :run
            JOIN runs_genomes AS rs
              ON c.subject_hash = rs.genome_hash AND rs.run_id = :run
            WHERE c.configuration_id = :config
            """,
            {"run": self.run_id, "config": self.configuration_id},
        ).fetchone()
        return int(done), int(null)

    # -- matrices ----------------------------------------------------------

    def cache_comparisons(self) -> None:
        """Build and store the five N x N matrices (ref db_orm.py:393-466).

        Vectorised scatter: at the 1000-genome design point a run holds
        10^6 comparison rows, and a per-row Python loop costs ~8 s where
        the pandas map + fancy-index assignment is ~2 s.
        """
        import pandas as pd

        hashes = self.genome_hashes
        size = len(hashes)
        index = {h: i for i, h in enumerate(hashes)}
        identity = np.full([size, size], np.nan, float)
        cov_query = np.full([size, size], np.nan, float)
        aln_length = np.full([size, size], np.nan, float)
        sim_errors = np.full([size, size], np.nan, float)
        # The hash -> matrix-position mapping runs inside SQLite (temp
        # join) and NULLs come back as +inf (1e999), so the result set
        # is pure numeric tuples that np.asarray ingests in C. Fetch
        # with a plain-tuple cursor: the sqlite3.Row wrapper costs ~20%
        # at a million rows.
        conn = self._db.conn
        conn.execute("DROP TABLE IF EXISTS temp.matrix_pos")
        conn.execute(
            "CREATE TEMP TABLE matrix_pos (hash TEXT PRIMARY KEY, idx INTEGER)"
        )
        conn.executemany(
            "INSERT INTO temp.matrix_pos VALUES (?, ?)", list(index.items())
        )
        cur = conn.execute(
            """
            SELECT pq.idx, ps.idx,
                   IFNULL(c.identity, 1e999), IFNULL(c.cov_query, 1e999),
                   IFNULL(c.aln_length, 1e999), IFNULL(c.sim_errors, 1e999)
            FROM comparisons AS c
            JOIN temp.matrix_pos AS pq ON c.query_hash = pq.hash
            JOIN temp.matrix_pos AS ps ON c.subject_hash = ps.hash
            WHERE c.configuration_id = :config
            """,
            {"config": self.configuration_id},
        )
        cur.row_factory = None
        data = cur.fetchall()
        conn.execute("DROP TABLE IF EXISTS temp.matrix_pos")
        if data:
            arr = np.asarray(data, dtype=np.float64)
            arr[np.isinf(arr)] = np.nan  # the IFNULL sentinel
            rows = arr[:, 0].astype(np.intp)
            cols = arr[:, 1].astype(np.intp)
            identity[rows, cols] = arr[:, 2]
            cov_query[rows, cols] = arr[:, 3]
            aln_length[rows, cols] = arr[:, 4]
            sim_errors[rows, cols] = arr[:, 5]

        def to_json(matrix: np.ndarray) -> str:
            # double_precision=15 keeps full float64 round-trip fidelity
            # (the reference's default-10 truncation is also within the
            # 2e-8 test tolerance, but exactness is free here).
            return pd.DataFrame(
                data=matrix, index=hashes, columns=hashes, dtype=float
            ).to_json(orient="split", double_precision=15)

        self._df["identity"] = to_json(identity)
        self._df["cov_query"] = to_json(cov_query)
        self._df["hadamard"] = to_json(identity * cov_query)
        self._df["aln_length"] = to_json(aln_length)
        self._df["sim_errors"] = to_json(sim_errors)
        self._db.execute_with_retries(
            "UPDATE runs SET df_identity=?, df_cov_query=?, df_aln_length=?,"
            " df_sim_errors=?, df_hadamard=? WHERE run_id=?",
            (
                self._df["identity"],
                self._df["cov_query"],
                self._df["aln_length"],
                self._df["sim_errors"],
                self._df["hadamard"],
                self.run_id,
            ),
        )

    def _matrix(self, key: str):
        import pandas as pd

        blob = self._df.get(key)
        if not blob:
            return None
        return pd.read_json(StringIO(blob), orient="split", dtype=float)

    @property
    def identities(self):
        return self._matrix("identity")

    @property
    def cov_query(self):
        return self._matrix("cov_query")

    @property
    def aln_length(self):
        return self._matrix("aln_length")

    @property
    def sim_errors(self):
        return self._matrix("sim_errors")

    @property
    def hadamard(self):
        return self._matrix("hadamard")

    @property
    def tani(self):
        """-ln(hadamard), element-wise, NaN propagating (db_orm.py:566-588)."""
        hadamard = self.hadamard
        if hadamard is None:
            return None
        return hadamard.map(lambda x: -math_log(x) if x else nan, na_action="ignore")

    def relabelled_matrix(self, matrix, label: str = "md5"):
        """Relabel an MD5-indexed matrix by filename or stem (db_orm.py:590-624)."""
        if label == "md5":
            return matrix
        if label == "filename":
            mapping = self.hash_to_filename
        elif label == "stem":
            mapping = {
                h: filename_stem(f) for h, f in self.hash_to_filename.items()
            }
            if len(set(mapping.values())) < len(mapping):
                msg = "Duplicate filename stems, consider using MD5 labelling."
                raise ValueError(msg)
        else:
            msg = f"Unexpected label scheme {label!r}"
            raise ValueError(msg)
        matrix = matrix.rename(index=mapping, columns=mapping)
        matrix = matrix.sort_index(axis=0).sort_index(axis=1)
        return matrix

    def set_status(self, status: str) -> None:
        self.status = status
        self._db.execute_with_retries(
            "UPDATE runs SET status=? WHERE run_id=?", (status, self.run_id)
        )


class Database:
    """SQLite-backed store with retry/backoff and idempotent inserts."""

    def __init__(
        self,
        path: Path | str,
        *,
        create: bool = False,
        logger: logging.Logger | None = None,
    ) -> None:
        self.path = str(path)
        self.logger = logger or logging.getLogger(__package__)
        if self.path != ":memory:" and not create and not Path(self.path).is_file():
            msg = f"Database {self.path} does not exist"
            raise FileNotFoundError(msg)
        last: Exception | None = None
        for attempt in range(_ATTEMPTS):
            try:
                self.conn = sqlite3.connect(self.path, timeout=10)
                break
            except sqlite3.OperationalError as err:  # pragma: no cover
                last = err
                time.sleep(random.uniform(0.5, 2.0) * (attempt + 1))  # noqa: S311
        else:  # pragma: no cover
            raise RuntimeError(f"Could not connect to {self.path}: {last}")
        self.conn.row_factory = sqlite3.Row
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()

    def __enter__(self) -> Database:
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    def execute_with_retries(self, sql: str, params: Any = ()) -> sqlite3.Cursor:
        """Execute + commit with retry/backoff (ref db_orm.py:1044-1114)."""
        last: Exception | None = None
        for attempt in range(_ATTEMPTS):
            try:
                cur = self.conn.execute(sql, params)
                self.conn.commit()
                return cur
            except sqlite3.OperationalError as err:  # pragma: no cover
                last = err
                time.sleep(random.uniform(0.5, 2.0) * (attempt + 1))  # noqa: S311
        raise RuntimeError(f"Database write failed after retries: {last}")  # pragma: no cover

    # -- genomes -----------------------------------------------------------

    def add_genome(
        self, genome_hash: str, path: str, length: int, description: str
    ) -> None:
        """Idempotent insert of a genome row (ref db_orm.py:785-877)."""
        self.execute_with_retries(
            "INSERT OR IGNORE INTO genomes (genome_hash, path, length, description)"
            " VALUES (?, ?, ?, ?)",
            (genome_hash, path, length, description),
        )

    # -- configurations ----------------------------------------------------

    def get_or_create_configuration(  # noqa: PLR0913
        self,
        method: str,
        program: str,
        version: str,
        *,
        fragsize: int | None = None,
        mode: str | None = None,
        kmersize: int | None = None,
        minmatch: float | None = None,
        extra: str | None = None,
        create: bool = True,
    ) -> Configuration:
        where = (
            "method=? AND program=? AND version=? AND fragsize IS ? AND mode IS ?"
            " AND kmersize IS ? AND minmatch IS ? AND extra IS ?"
        )
        params = (method, program, version, fragsize, mode, kmersize, minmatch, extra)
        row = self.conn.execute(
            f"SELECT * FROM configurations WHERE {where}", params  # noqa: S608
        ).fetchone()
        if row is None:
            if not create:
                msg = f"Configuration for {method} not found"
                raise ValueError(msg)
            self.execute_with_retries(
                "INSERT INTO configurations"
                " (method, program, version, fragsize, mode, kmersize, minmatch, extra)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                params,
            )
            row = self.conn.execute(
                f"SELECT * FROM configurations WHERE {where}", params  # noqa: S608
            ).fetchone()
        return Configuration(**dict(row))

    def get_configuration(self, configuration_id: int) -> Configuration:
        row = self.conn.execute(
            "SELECT * FROM configurations WHERE configuration_id=?",
            (configuration_id,),
        ).fetchone()
        if row is None:
            msg = f"Configuration {configuration_id} not found"
            raise ValueError(msg)
        return Configuration(**dict(row))

    # -- runs --------------------------------------------------------------

    def add_run(  # noqa: PLR0913
        self,
        configuration_id: int,
        cmdline: str,
        fasta_directory: str,
        status: str,
        name: str,
        genomes: list[tuple[str, str]],  # (hash, as-given filename)
    ) -> Run:
        cur = self.execute_with_retries(
            "INSERT INTO runs (configuration_id, cmdline, fasta_directory, date,"
            " status, name) VALUES (?, ?, ?, ?, ?, ?)",
            (
                configuration_id,
                cmdline,
                fasta_directory,
                datetime.datetime.now(tz=datetime.UTC).isoformat(),
                status,
                name,
            ),
        )
        run_id = cur.lastrowid
        self.conn.executemany(
            "INSERT OR IGNORE INTO runs_genomes (run_id, genome_hash, fasta_filename)"
            " VALUES (?, ?, ?)",
            [(run_id, h, f) for h, f in genomes],
        )
        self.conn.commit()
        return self.load_run(run_id)

    def load_run(
        self,
        run_id: int | None = None,
        *,
        check_complete: bool = False,
        check_empty: bool = False,
    ) -> Run:
        """Load a run by id, or the latest (ref db_orm.py:921-975)."""
        if run_id is None:
            row = self.conn.execute(
                "SELECT * FROM runs ORDER BY run_id DESC LIMIT 1"
            ).fetchone()
            if row is None:
                msg = "Database contains no runs"
                raise ValueError(msg)
        else:
            row = self.conn.execute(
                "SELECT * FROM runs WHERE run_id=?", (run_id,)
            ).fetchone()
            if row is None:
                msg = f"Database has no run-id {run_id}"
                raise ValueError(msg)
        run = Run(self, row)
        if check_complete or check_empty:
            n = len(run.genome_hashes)
            done = run.comparisons_count()
            if check_empty and not done:
                msg = f"Run-id {run.run_id} has no comparisons"
                raise ValueError(msg)
            if check_complete:
                if done != n * n:
                    msg = (
                        f"Run-id {run.run_id} only has {done} of {n}²={n * n}"
                        " comparisons, cannot use that"
                    )
                    raise ValueError(msg)
                if not run._df.get("identity"):  # noqa: SLF001
                    run.cache_comparisons()
        return run

    def list_runs(self) -> list[Run]:
        return [
            Run(self, row)
            for row in self.conn.execute("SELECT * FROM runs ORDER BY run_id")
        ]

    def delete_run(self, run_id: int) -> None:
        self.execute_with_retries("DELETE FROM runs_genomes WHERE run_id=?", (run_id,))
        self.execute_with_retries("DELETE FROM runs WHERE run_id=?", (run_id,))

    # -- comparisons -------------------------------------------------------

    def insert_comparisons(
        self, rows: list[dict[str, Any]], *, configuration_id: int
    ) -> int:
        """Bulk INSERT OR IGNORE of comparison dicts; returns rows attempted.

        Idempotent by the (query_hash, subject_hash, configuration_id)
        uniqueness constraint -- duplicate work merges cleanly, which is
        what makes interrupt/resume and multi-host merges safe
        (ref db_orm.py:1044-1114).
        """
        import platform

        uname = platform.uname()
        payload = [
            (
                configuration_id,
                r["query_hash"],
                r["subject_hash"],
                r.get("identity"),
                r.get("aln_length"),
                r.get("sim_errors"),
                r.get("cov_query"),
                r.get("cov_subject"),
                r.get("uname_system", uname.system),
                r.get("uname_release", uname.release),
                r.get("uname_machine", uname.machine),
            )
            for r in rows
        ]
        last: Exception | None = None
        for attempt in range(_ATTEMPTS):
            try:
                self.conn.executemany(
                    "INSERT OR IGNORE INTO comparisons (configuration_id, query_hash,"
                    " subject_hash, identity, aln_length, sim_errors, cov_query,"
                    " cov_subject, uname_system, uname_release, uname_machine)"
                    " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    payload,
                )
                self.conn.commit()
                return len(payload)
            except sqlite3.OperationalError as err:  # pragma: no cover
                last = err
                time.sleep(random.uniform(0.5, 2.0) * (attempt + 1))  # noqa: S311
        raise RuntimeError(  # pragma: no cover
            f"Comparison insert failed after retries: {last}"
        )

    def existing_pairs(
        self, configuration_id: int, hashes: list[str]
    ) -> set[tuple[str, str]]:
        """Which (query, subject) pairs over ``hashes`` are already done."""
        if not hashes:
            return set()  # "IN ()" is a SQLite syntax error
        placeholders = ",".join("?" * len(hashes))
        cur = self.conn.execute(
            f"SELECT query_hash, subject_hash FROM comparisons"  # noqa: S608
            f" WHERE configuration_id=? AND query_hash IN ({placeholders})"
            f" AND subject_hash IN ({placeholders})",
            (configuration_id, *hashes, *hashes),
        )
        return {(row[0], row[1]) for row in cur}
