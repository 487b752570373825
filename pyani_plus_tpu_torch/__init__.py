"""pyANI-plus-TPU on PyTorch and CUDA: the port for one NVIDIA H100.

A second package beside ``pyani_plus_tpu`` (the JAX reference, which
stays as it is). It stands alone: it imports ``torch``, never ``jax``
and nothing of the JAX package, and keeps its own copy of every module
it needs from there (genome ingest, the store, reports, the native host
kernels, the numpy ops) under the same module names, so that each module
has an obvious counterpart. Each Pallas kernel on a ported path is a
kernel written by hand for Hopper under ``csrc/``, built with nvcc at
first use. Only the tests import both packages, to compare them.

Layout:

- ``backend.py``  -- explicit CUDA/nvcc/device probe
- ``csrc/``       -- the hand-written CUDA kernels
- ``native/``     -- the C++ host kernels (built with g++ at first use)
- ``ops/``        -- kernel builds, wrappers, their plain PyTorch versions
                     and the numpy host ops
- ``methods/``    -- the ported methods (ANIm, dnadiff, ANIb, sourmash)
- ``parallel/``   -- the run driver
- ``genomes/``, ``utils/``, ``db/``, ``report/`` -- ingest, store, reports
- ``cli/``        -- the ``pyani-plus-tpu-torch`` command line
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

# The same string as the JAX package's: configuration rows and the resume
# version check compare it, so a run started by one package resumes
# under the other (tests/test_torch_cli.py holds the two equal).
__version__ = "0.1.0"

LOG_FILE = Path("pyani-plus.log")
LOG_FILE_DYNAMIC = Path("--")  # internal sentinel, not exposed in CLI
FASTA_EXTENSIONS = {".fasta", ".fas", ".fna", ".fa"}  # plus .gz variants
GRAPHICS_FORMATS = ("tsv", "png", "jpg", "svgz", "pdf")

__all__ = [
    "FASTA_EXTENSIONS",
    "GRAPHICS_FORMATS",
    "LOG_FILE",
    "__version__",
    "log_sys_exit",
    "setup_logger",
]


def setup_logger(
    log_file: Path | None,
    *,
    terminal_level: int = logging.INFO,
    plain: bool = False,
) -> logging.Logger:
    """Return a console logger plus an optional always-DEBUG file logger.

    Terminal handler at ``terminal_level`` (Rich console unless
    ``plain``), file handler always at DEBUG with a timestamped format.
    Use ``None`` or ``Path("-")`` for no log file.
    """
    if log_file == LOG_FILE_DYNAMIC:
        sys.exit("ERROR: Internal flag value for dynamic log setting unresolved")
    logger = logging.getLogger(__package__)
    min_level = min(logging.DEBUG, terminal_level)
    logger.setLevel(min_level)
    if logger.hasHandlers():
        logger.handlers.clear()

    if plain:
        console_handler: logging.Handler = logging.StreamHandler()
        console_handler.setLevel(terminal_level)
    else:
        try:
            from rich.logging import RichHandler

            console_handler = RichHandler(
                level=terminal_level,
                markup=True,
                omit_repeated_times=False,
                show_path=False,
                rich_tracebacks=True,
                tracebacks_suppress=["click"],
            )
        except ImportError:  # pragma: no cover - rich is expected to exist
            console_handler = logging.StreamHandler()
            console_handler.setLevel(terminal_level)
    logger.addHandler(console_handler)

    if log_file and log_file != Path("-"):
        file_handler = logging.FileHandler(log_file, mode="a")
        file_handler.setLevel(logging.DEBUG)
        file_handler.setFormatter(
            logging.Formatter(
                fmt="%(asctime)s %(levelname)9s %(filename)21s:%(lineno)-3s | %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(file_handler)
        logger.info("Logging to '%s'", log_file)
    else:
        logger.debug("Currently not logging to file.")

    return logger


def log_sys_exit(logger: logging.Logger, msg: str) -> None:
    """Log a CRITICAL message then ``sys.exit`` with it."""
    logger.critical(msg)
    sys.exit(msg)
