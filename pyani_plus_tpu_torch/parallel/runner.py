"""The port's run driver: ingest genomes, compute pending pairs, persist.

Port of ``pyani_plus_tpu/parallel/runner.py`` with the same contract:
duplicate-MD5 check, idempotent genome/configuration/run rows, pending
pairs derived from the store (comparisons of any earlier run with the
same configuration are reused), incremental flushes, graceful
interrupts, the version check on resume and the cached matrices, and
the same process group: launched as one (``launch``, or a cluster
launcher with the opt-in), a run joins the ``torch.distributed`` group
(``parallel/distributed.py``), host 0's pending set is broadcast, each
host computes its static share of the pair grid, and the rows merge
through an all-gather into host 0's store. It differs in what reached JAX
there: ``PYANI_TPU_PROFILE=<dir>`` writes a ``torch.profiler`` trace of
the whole run with the program's spans in it, and the progress bar needs
``rich``. The stages carry spans (``utils/spans.py``): ``runner.md5``,
``runner.parse`` (and the counter ``runner.parses``), ``runner.genome_rows``,
``runner.load``, ``runner.compute``, ``runner.store`` and ``runner.cache``.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import signal
from collections.abc import Callable
from pathlib import Path
from typing import Any

import torch

from pyani_plus_tpu_torch import __version__, backend, log_sys_exit
from pyani_plus_tpu_torch.db import Database, Run
from pyani_plus_tpu_torch.genomes import Genome, load_genome
from pyani_plus_tpu_torch.methods import CARD_METHODS, ComputeContext, get_method
from pyani_plus_tpu_torch.parallel import distributed
from pyani_plus_tpu_torch.parallel.tiles import owned_pairs
from pyani_plus_tpu_torch.utils import check_fasta, file_md5sum, spans


def index_fasta_directory(
    logger: logging.Logger, fasta: Path
) -> dict[str, Path]:
    """MD5-index a FASTA directory; error on duplicate genome content."""
    with spans.span("runner.md5"):
        filename_to_hash = {f: file_md5sum(f) for f in check_fasta(logger, fasta)}
    hash_to_filename: dict[str, Path] = {}
    for filename, md5 in filename_to_hash.items():
        if md5 in hash_to_filename:
            msg = (
                f"Multiple genomes with same MD5 checksum {md5}:\n"
                f" - {hash_to_filename[md5]}\n - {filename}"
            )
            log_sys_exit(logger, msg)
        hash_to_filename[md5] = filename
    return hash_to_filename


# the profiler traces every thread: the pair and strand threads' spans too
_ALL_THREADS = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def _profiled(run: Callable[..., int]) -> Callable[..., int]:
    """Under ``PYANI_TPU_PROFILE=<dir>``, the whole of ``run`` in one
    ``torch.profiler`` session (the card's kernels too, where there is a
    card), with the program's spans recorded as ranges of the same trace
    inside a range named after ``run``, written to
    ``<dir>/trace-<pid>.json`` at its end. Inside a session that is
    already open (``resume_run`` within ``start_and_run_method``), and
    without the variable, ``run`` alone."""

    @functools.wraps(run)
    def profiled(logger: logging.Logger, *args: Any, **kwargs: Any) -> int:
        profile_dir = os.environ.get("PYANI_TPU_PROFILE")
        if not profile_dir or spans.profiling():
            return run(logger, *args, **kwargs)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if backend.cards():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with (
            spans.recording(),
            torch.profiler.profile(activities=activities, experimental_config=_ALL_THREADS) as prof,
            torch.profiler.record_function(run.__name__),
        ):
            run_id = run(logger, *args, **kwargs)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        trace = Path(profile_dir) / f"trace-{os.getpid()}.json"
        prof.export_chrome_trace(str(trace))
        logger.info("Wrote profiler trace to %s", trace)
        return run_id

    return profiled


@_profiled
def start_and_run_method(  # noqa: PLR0913
    logger: logging.Logger,
    database: Path | str,
    fasta: Path,
    method_name: str,
    *,
    name: str | None = None,
    cmdline: str = "",
    create_db: bool = False,
    cache: Path | None = None,
    extra_files: dict[str, Path] | None = None,
    **params: Any,
) -> int:
    """Full run of one method over a FASTA directory; returns run_id."""
    method = get_method(method_name)
    require_device(logger, method_name)  # before anything is stored
    config = method.configuration(**params)
    # Ingest problems surface as one CRITICAL line and a clean exit.
    try:
        hash_to_filename = index_fasta_directory(logger, fasta)
        logger.info("Indexed %d genomes from %s", len(hash_to_filename), fasta)
        db = Database(database, create=create_db, logger=logger)
    except ValueError as exc:
        log_sys_exit(logger, str(exc))
        raise  # pragma: no cover - log_sys_exit raises SystemExit
    try:
        try:
            run = _setup_run(
                logger, db, fasta, config, hash_to_filename, name,
                cmdline, method_name
            )
        except ValueError as exc:
            log_sys_exit(logger, str(exc))
            raise  # pragma: no cover - log_sys_exit raises SystemExit
        return resume_run(
            logger,
            db,
            run,
            hash_to_filename=hash_to_filename,
            cache=cache,
            extra_files=extra_files,
        )
    finally:
        db.close()


def require_device(logger: logging.Logger, method_name: str) -> None:
    """Resolve the device of a method with work for the card
    (``methods.CARD_METHODS``), at any input size: the card, or the CPU
    when ``PYANI_TPU_TORCH_DEVICE=cpu`` asks for it. A refusal (no card, a
    card the kernels do not run on, a bad value) exits with its message.
    The host-only methods need no device."""
    if method_name not in CARD_METHODS:
        return
    try:
        device = backend.kernel_device()
    except (RuntimeError, ValueError) as err:
        log_sys_exit(logger, f"{method_name}: {err}")
    logger.info("%s runs on %s", method_name, device)


def _setup_run(  # noqa: PLR0913
    logger: logging.Logger,
    db: Database,
    fasta: Path,
    config: dict[str, Any],
    hash_to_filename: dict[str, Path],
    name: str | None,
    cmdline: str,
    method_name: str,
) -> Run:
    with spans.span("runner.genome_rows"):
        configuration = db.get_or_create_configuration(
            config["method"],
            config["program"],
            config["version"],
            fragsize=config.get("fragsize"),
            mode=config.get("mode"),
            kmersize=config.get("kmersize"),
            minmatch=config.get("minmatch"),
            extra=config.get("extra"),
        )
    for md5, filename in hash_to_filename.items():
        genome = _parse(filename, md5)
        with spans.span("runner.genome_rows"):
            db.add_genome(md5, str(filename), genome.length, genome.description)
    n = len(hash_to_filename)
    with spans.span("runner.genome_rows"):
        return db.add_run(
            configuration.configuration_id,
            cmdline,
            str(fasta),
            "Initialising",
            name or f"{n} genomes using {method_name}",
            [(md5, filename.name) for md5, filename in hash_to_filename.items()],
        )


def _parse(filename: Path, md5: str) -> Genome:
    """One FASTA parse, as the span ``runner.parse`` and the counter
    ``runner.parses``."""
    with spans.span("runner.parse"):
        genome = load_genome(filename, md5)
    spans.count("runner.parses")
    return genome


@contextlib.contextmanager
def _defer_interrupts(logger: logging.Logger):
    """Queue SIGINT/SIGTERM for the duration of run finalisation.

    Once the comparisons are computed, persisting them and caching the
    matrices is strictly better than abandoning the run mid-commit: an
    interrupt here would leave a fully-computed run stuck "Running"
    (unresumable work lost to a race). Signals received while deferred
    are logged after the store is consistent.
    """
    received: list[int] = []
    saved = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            saved[sig] = signal.signal(
                sig, lambda signum, _frame: received.append(signum)
            )
        except ValueError:  # pragma: no cover - non-main thread
            pass
    try:
        yield
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
        if received:  # pragma: no cover - timing dependent
            logger.warning(
                "Interrupt received during run finalisation; results were "
                "already complete and have been persisted"
            )


def _progress(description: str, total: int):
    """A transient rich progress bar, or none when rich is absent:
    (context manager, callback advancing it by n pairs)."""
    try:
        from rich.progress import (
            BarColumn,
            MofNCompleteColumn,
            Progress,
            SpinnerColumn,
            TimeElapsedColumn,
        )
    except ImportError:
        return contextlib.nullcontext(), None
    progress = Progress(
        SpinnerColumn(),
        "[progress.description]{task.description}",
        BarColumn(),
        MofNCompleteColumn(),
        TimeElapsedColumn(),
        transient=True,
    )
    task_id = progress.add_task(description, total=total)
    return progress, lambda n: progress.advance(task_id, n)


def _compute(method: Any, ctx: ComputeContext) -> list[dict]:
    """Run the method."""
    with spans.span("runner.compute"):
        return method.compute(ctx)


@_profiled
def resume_run(  # noqa: PLR0913, C901
    logger: logging.Logger,
    db: Database,
    run: Run,
    *,
    hash_to_filename: dict[str, Path] | None = None,
    cache: Path | None = None,
    extra_files: dict[str, Path] | None = None,
) -> int:
    """Compute whatever comparisons the run still needs; finalise it."""
    config_obj = run.configuration
    config = {
        "method": config_obj.method,
        "program": config_obj.program,
        "version": config_obj.version,
        "fragsize": config_obj.fragsize,
        "mode": config_obj.mode,
        "kmersize": config_obj.kmersize,
        "minmatch": config_obj.minmatch,
        "extra": config_obj.extra,
    }
    method = get_method(config_obj.method)

    # The recorded program version must match the one running now.
    if config_obj.version and config_obj.version != __version__:
        log_sys_exit(
            logger,
            f"Run {run.run_id} used {config_obj.program} version "
            f"{config_obj.version}, but this is {__version__} -- cannot "
            "resume (rerun instead; matching the reference's tool-version "
            "equality check)",
        )

    hashes = run.genome_hashes
    n = len(hashes)
    if hash_to_filename is None:
        hash_to_filename = {
            h: Path(run.fasta_directory) / f for h, f in run.hash_to_filename.items()
        }
    backend.probe()
    # A worker that cannot have its device fails here, before it joins the
    # group: no peer is left waiting for it in a collective.
    require_device(logger, config_obj.method)

    # Join the process group when launched as one (the `launch` command or
    # a cluster launcher sets the coordinator env).
    dist_index, dist_count = distributed.maybe_initialize(logger)
    collective = dist_count > 1

    done = db.existing_pairs(run.configuration_id, hashes)
    pending = {(q, s) for q in hashes for s in hashes if (q, s) not in done}
    if collective:
        # Host 0's store is authoritative; workers may hold private
        # database files (no shared filesystem needed).
        pending = distributed.broadcast_pending(pending, dist_index)
    logger.info(
        "Run %d: %d of %d comparisons already done, %d pending",
        run.run_id,
        n * n - len(pending),
        n * n,
        len(pending),
    )

    # Static share of the pair grid per host (parallel/tiles.owned_pairs);
    # INSERT OR IGNORE makes the merge idempotent and `resume` sweeps up
    # whatever a host never computed. Host identity comes from the
    # PYANI_TPU_PROCESS_{INDEX,COUNT} env, else from the process group.
    proc_count = int(os.environ.get("PYANI_TPU_PROCESS_COUNT", "0"))
    proc_index = int(os.environ.get("PYANI_TPU_PROCESS_INDEX", "0"))
    if not proc_count:
        proc_count, proc_index = dist_count, dist_index
    if proc_count > 1:
        mine = {
            (hashes[q], hashes[s]) for q, s in owned_pairs(n, proc_index, proc_count)
        }
        pending &= mine
        logger.info(
            "Host %d/%d owns %d of the pending pairs",
            proc_index,
            proc_count,
            len(pending),
        )

    interrupted = False
    rows: list[dict] = []
    if pending:
        # SLURM sends SIGTERM; convert it to KeyboardInterrupt so the
        # graceful-interrupt path runs.
        def _terminate(_signum, _frame):  # pragma: no cover - signal path
            raise KeyboardInterrupt

        with contextlib.suppress(ValueError):  # non-main thread
            signal.signal(signal.SIGTERM, _terminate)

        # Everything from here on is interrupt-protected, genome loading
        # included, so an interrupt never leaves the run "Running".
        ctx = None
        try:
            run.set_status("Running")
            with spans.span("runner.load"):
                genomes: dict[str, Genome] = {
                    md5: _parse(hash_to_filename[md5], md5) for md5 in hashes
                }

            def flush(rows: list[dict]) -> None:
                # Incremental persist: INSERT OR IGNORE makes repeats harmless
                with spans.span("runner.store"):
                    db.insert_comparisons(rows, configuration_id=run.configuration_id)
                logger.debug("Flushed %d comparisons", len(rows))

            progress, advance = _progress(
                f"{config.get('method', 'ANI')} comparisons", len(pending)
            )
            ctx = ComputeContext(
                logger=logger,
                genomes=genomes,
                query_hashes=hashes,
                subject_hashes=hashes,
                pending=pending,
                config=config,
                cache=cache,
                extra_files=extra_files or {},
                progress=advance,
                flush=flush,
            )
            with progress:
                rows = _compute(method, ctx)
        except KeyboardInterrupt:
            if not collective:
                logger.error("Interrupted; marking run as 'Worker interrupted'")
                run.set_status("Worker interrupted")
                return run.run_id
            # In a process group, still join the merge below with
            # whatever was completed so the peers don't deadlock.
            interrupted = True
        interrupted = interrupted or (ctx is not None and ctx.interrupted)

    if collective:
        # The collective merge replaces the reference's polled JSON
        # import: every host receives the union, and host 0 stores it, so
        # its store ends complete even when workers use private
        # databases. EVERY host joins, those with no pending share too
        # (the gather is also the completion barrier). It stays OUTSIDE
        # the signal-defer window: it is a network barrier that blocks if
        # a peer dies, and the worker must stay interruptible during it
        # -- an interrupt falls through to persist this host's own rows.
        try:
            gathered = distributed.allgather_comparisons(rows)
            logger.info(
                "Collective merge: %d local + %d remote comparisons",
                len(rows),
                len(gathered) - len(rows),
            )
            rows = gathered if dist_index == 0 else rows
        except KeyboardInterrupt:  # pragma: no cover - timing dependent
            logger.error(
                "Interrupted during collective merge; keeping this host's local results"
            )
            interrupted = True
    with _defer_interrupts(logger):
        if rows:
            with spans.span("runner.store"):
                db.insert_comparisons(rows, configuration_id=run.configuration_id)
        if interrupted:
            run.set_status("Worker interrupted")
            logger.error("Run %d interrupted; partial results saved", run.run_id)
            return run.run_id

        final = run.comparisons_count()
        if final != n * n:
            if proc_count > 1:
                # Another host still owns the missing pairs; whoever
                # finishes last (or a `resume`) completes and caches the run.
                logger.info(
                    "Host %d/%d done with its share: %d of %d comparisons stored",
                    proc_index,
                    proc_count,
                    final,
                    n * n,
                )
                return run.run_id
            msg = (
                f"Run {run.run_id} has {final} of {n}²={n * n} comparisons"
                " after compute -- method returned incomplete results"
            )
            log_sys_exit(logger, msg)
        with spans.span("runner.cache"):
            run.cache_comparisons()
            run.set_status("Done")
        logger.info("Run %d complete: %d comparisons", run.run_id, final)
        return run.run_id
