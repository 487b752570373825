"""The port's method registry: the JAX package's eight methods.

A method module exposes ``NAME``, ``configuration(**params)`` (the
configuration column values) and ``compute(ctx)`` (comparison dicts for
the requested pairs). ``ComputeContext`` and ``run_pairwise`` are the
JAX package's, kept as they are there, so a ported method drives pairs,
ticks progress and flushes exactly as the reference does.
"""

from __future__ import annotations

import importlib
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from pyani_plus_tpu_torch.genomes import Genome

__all__ = ["CARD_METHODS", "ComputeContext", "get_method", "method_names", "run_pairwise"]

FLUSH_WINDOW = 300.0  # seconds between incremental flushes (ref JSON_WINDOW)


@dataclass
class ComputeContext:
    """Everything a method needs to compute a batch of pairs."""

    logger: logging.Logger
    genomes: dict[str, Genome]  # md5 -> Genome (all genomes in the run)
    query_hashes: list[str]
    subject_hashes: list[str]
    pending: set[tuple[str, str]]  # (query, subject) pairs still to compute
    config: dict[str, Any]  # configuration column values
    cache: Path | None = None
    extra_files: dict[str, Path] = field(default_factory=dict)
    progress: Callable[[int], None] | None = None  # called with #pairs done
    flush: Callable[[list[dict]], None] | None = None  # incremental persist
    interrupted: bool = False  # set when a method caught SIGINT/SIGTERM
    _last_flush: float = field(default=0.0, repr=False)

    def tick(self, n: int = 1) -> None:
        if self.progress is not None:
            self.progress(n)

    def maybe_flush(self, rows: list[dict]) -> None:
        """Persist completed rows if the flush window elapsed.

        Safe to call with the full accumulated list: the store's INSERT
        OR IGNORE dedupe makes repeated flushes idempotent (the
        reference's 300 s JSON flush discipline).
        """
        import time

        if self.flush is None:
            return
        now = time.monotonic()
        if not self._last_flush:
            self._last_flush = now
        elif now - self._last_flush >= FLUSH_WINDOW:
            self.flush(rows)
            self._last_flush = now


# Method name (as stored in configurations) -> module of this package.
_MODULES = {
    "sourmash": "sourmash",
    "fastANI": "fastani",
    "ANIm": "anim",
    "ANIb": "anib",
    "ANIminimap2": "animinimap2",
    "dnadiff": "dnadiff",
    "skani": "skani",
    "external-alignment": "external_alignment",
}


# The methods with work for the card; they resolve the device
# (``backend.kernel_device``) before any work. The others run on the host,
# as in the JAX package, and need no device.
CARD_METHODS = frozenset({"ANIm", "dnadiff", "ANIb", "sourmash"})


def method_names() -> list[str]:
    return list(_MODULES)


def get_method(name: str) -> Any:
    try:
        modname = _MODULES[name]
    except KeyError:
        msg = f"Unknown method {name!r}; known: {sorted(_MODULES)}"
        raise ValueError(msg) from None
    return importlib.import_module(f"pyani_plus_tpu_torch.methods.{modname}")


def run_pairwise(ctx: ComputeContext, fn: Callable[[str, str], dict]) -> list[dict]:
    """Drive a per-pair method with interrupt + incremental-flush handling.

    SIGINT/SIGTERM (as KeyboardInterrupt) stops cleanly: completed rows
    are returned (and flagged via ctx.interrupted) so the runner can
    persist partial work and mark the run "Worker interrupted" -- the
    reference workers' graceful-interrupt contract
    (private_cli.py:816-823).

    Pairs are computed through a thread pool sized to the host's
    available cores by default (the reference's local executor runs
    `--cores all`, workflows/__init__.py:158-171; the numeric kernels
    release the GIL inside ctypes/device calls, so independent pairs
    scale across host cores). PYANI_TPU_PAIR_WORKERS=K overrides the
    pool size; =1 opts out back to the serial loop. Results are emitted
    in completion order; the store is order-independent and the
    interrupt contract is preserved (completed rows survive, the rest
    are cancelled).
    """
    import os

    rows: list[dict] = []
    pairs = sorted(ctx.pending)
    env_workers = os.environ.get("PYANI_TPU_PAIR_WORKERS")
    if env_workers is not None:
        workers = int(env_workers)
    else:
        from pyani_plus_tpu_torch.utils import available_cores

        workers = available_cores()
    if workers > 1 and len(pairs) > 1:
        from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

        # Budget the WITHIN-pair pools by the pair-pool width so K
        # concurrent pairs don't oversubscribe the host (each pair's
        # extension/scoring pools read this at call time); an explicit
        # PYANI_TPU_INTRA_WORKERS is always respected.
        from pyani_plus_tpu_torch.utils import available_cores

        budget_set = "PYANI_TPU_INTRA_WORKERS" not in os.environ
        if budget_set:
            os.environ["PYANI_TPU_INTRA_WORKERS"] = str(
                max(1, available_cores() // workers)
            )
        pool = ThreadPoolExecutor(max_workers=workers)
        # try/finally so the intra-worker budget env var and the pool are
        # always restored/cleaned, whatever exception escapes f.result().
        try:
            try:
                futures = {
                    pool.submit(fn, q, s): (q, s) for q, s in pairs
                }
                outstanding = set(futures)
                while outstanding:
                    done, outstanding = wait(
                        outstanding, return_when=FIRST_COMPLETED
                    )
                    for fut in done:
                        q, s = futures[fut]
                        rows.append(
                            {"query_hash": q, "subject_hash": s, **fut.result()}
                        )
                        ctx.tick()
                    ctx.maybe_flush(rows)
            except KeyboardInterrupt:
                ctx.interrupted = True
                ctx.logger.error(
                    "Interrupted with %d completed comparisons", len(rows)
                )
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            if budget_set:
                os.environ.pop("PYANI_TPU_INTRA_WORKERS", None)
        return rows
    try:
        for query_hash, subject_hash in pairs:
            result = fn(query_hash, subject_hash)
            rows.append(
                {"query_hash": query_hash, "subject_hash": subject_hash, **result}
            )
            ctx.tick()
            ctx.maybe_flush(rows)
    except KeyboardInterrupt:
        ctx.interrupted = True
        ctx.logger.error("Interrupted with %d completed comparisons", len(rows))
    return rows
