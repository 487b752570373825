"""Host-side utility functions: FASTA parsing, MD5 identity, staging.

Behavioural parity with the reference ``pyani_plus/utils.py`` (semantics,
not code): byte-mode FASTA iteration stripping internal whitespace
(utils.py:40-90), gzip-transparent MD5 of *decompressed* content as the
genome identity (utils.py:142-196), ``.gz``-aware filename stems
(utils.py:93-105), SLURM-aware core counts (utils.py:199-214), and input
validation helpers (utils.py:217-242).
"""

from __future__ import annotations

import gzip
import hashlib
import logging
import os
from collections.abc import Iterator
from pathlib import Path
from typing import IO

from pyani_plus_tpu_torch import FASTA_EXTENSIONS, log_sys_exit

WHITESPACE = b" \t\r\n"


def fasta_bytes_iterator(
    handle: IO[bytes] | gzip.GzipFile,
) -> Iterator[tuple[bytes, bytes]]:
    """Parse a FASTA file in binary mode, yielding (description, sequence).

    The description is everything after ``>`` with trailing whitespace
    stripped; the sequence has *all* internal whitespace removed (so wrapped
    lines, stray spaces and embedded ``\\r`` collapse away). Same observable
    semantics as the reference iterator (utils.py:40-90): anything before
    the first ``>`` header is ignored, and an entirely header-less file
    yields nothing.

    >>> import io
    >>> list(fasta_bytes_iterator(io.BytesIO(b">seq one\\nAC GT\\nTT\\n")))
    [(b'seq one', b'ACGTTT')]
    >>> list(fasta_bytes_iterator(io.BytesIO(b"no header at all\\n")))
    []
    """
    if not isinstance(handle.read(0), bytes):
        msg = "Function fasta_bytes_iterator requires a handle in binary mode"
        raise ValueError(msg)

    title: bytes | None = None
    body = bytearray()
    for raw in handle:
        if raw.startswith(b">"):
            if title is not None:
                yield title, bytes(body).translate(None, WHITESPACE)
            title = raw[1:].rstrip()
            body.clear()
        elif title is not None:
            body += raw.rstrip()
    if title is not None:
        yield title, bytes(body).translate(None, WHITESPACE)


def filename_stem(filename: str) -> str:
    """Return the basename stem, dropping ``.gz`` plus one more suffix.

    >>> filename_stem("genomes/OP073605.fasta.gz")
    'OP073605'
    >>> filename_stem("no_suffix")
    'no_suffix'
    """
    name = filename.rsplit("/", 1)[-1]
    if name.endswith(".gz"):
        name = name[: -len(".gz")]
    cut = name.rfind(".")
    return name if cut <= 0 else name[:cut]


def str_md5sum(text: str, encoding: str = "ascii") -> str:
    """Return the 32-char hex MD5 of the given string (like ``md5sum``).

    >>> str_md5sum("pyani-plus\\n")
    'ac1427f5ff5221d9efdfecb6d2aa0c42'
    """
    return hashlib.md5(text.encode(encoding)).hexdigest()  # noqa: S324


def file_md5sum(filename: Path | str) -> str:
    """Return the MD5 of the (decompressed, for .gz) file contents.

    This fingerprint is the genome identity used throughout the framework,
    exactly as in the reference (utils.py:142-196): comparisons are cached
    keyed on it, so renames/moves/compression changes do not invalidate
    cached results.
    """
    fname = Path(filename)
    hash_md5 = hashlib.md5()  # noqa: S324
    try:
        try:
            with gzip.open(fname, "rb") as fhandle:
                for chunk in iter(lambda: fhandle.read(65536), b""):
                    hash_md5.update(chunk)
        except gzip.BadGzipFile:
            with fname.open("rb") as fhandle:
                for chunk in iter(lambda: fhandle.read(65536), b""):
                    hash_md5.update(chunk)
    except FileNotFoundError:
        msg = (
            f"Input {fname} is a broken symlink"
            if fname.is_symlink()
            else f"Input {fname} not found"
        )
        raise ValueError(msg) from None
    return hash_md5.hexdigest()


def available_cores() -> int:
    """How many CPU cores/threads are available (SLURM-affinity aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-Linux
        cpus = os.cpu_count()
        if not cpus:
            msg = "Cannot determine CPU count"
            raise RuntimeError(msg) from None
        return cpus


def intra_pair_workers(cap: int = 8) -> int:
    """Thread-pool width for WITHIN-pair stages (extensions, cluster DPs,
    candidate scoring).

    Defaults to the host's cores (capped); ``PYANI_TPU_INTRA_WORKERS``
    overrides -- set it to 1 when an external scheduler (SLURM, the
    `launch` fan-out, the scaling benchmark) already assigns one process
    per core, the same role OMP_NUM_THREADS plays for OpenMP tools.
    """
    env = os.environ.get("PYANI_TPU_INTRA_WORKERS")
    if env is not None:
        return max(1, int(env))
    return max(1, min(cap, available_cores()))


def check_db(logger: logging.Logger, database: Path | str, create_db: bool) -> None:  # noqa: FBT001
    """Check the database exists, or that --create-db was passed."""
    logger.debug("Checking DB argument '%s'", database)
    if database != ":memory:" and not create_db and not Path(database).is_file():
        msg = f"Database {database} does not exist, but not using --create-db"
        log_sys_exit(logger, msg)


def check_fasta(logger: logging.Logger, fasta: Path) -> list[Path]:
    """Check ``fasta`` is a directory; return the FASTA files inside it."""
    logger.debug("Checking FASTA argument '%s'", fasta)
    if not fasta.is_dir():
        msg = f"FASTA input {fasta} is not a directory"
        log_sys_exit(logger, msg)

    fasta_names: list[Path] = []
    for pattern in FASTA_EXTENSIONS:
        fasta_names.extend(fasta.glob("*" + pattern))
        fasta_names.extend(fasta.glob("*" + pattern + ".gz"))
    if not fasta_names:
        msg = (
            f"No FASTA input genomes under {fasta} with extensions "
            f"{', '.join(sorted(FASTA_EXTENSIONS))}"
        )
        log_sys_exit(logger, msg)
    return sorted(fasta_names)
