"""The program's own spans and counters (``pyani_plus_tpu_torch.utils
.spans``), read over the window by the per-layer readers.

``install`` switches the program's recorder on through
``probes.replace`` (so that ``close`` switches it off again) and keeps
a snapshot of its totals and counters. ``read`` gives a name's growth
over the window, divided by the window's iterations: of a span its
seconds (or its self or top seconds), of a counter its count.

A program without the recorder (a checkout from before it) gives nothing
to read: the reader returns None and the result line leaves the metric
out. A program with it declares every name it records (``NAMES``): a
name it no longer declares is refused, so that a renamed or dropped span
never drops its metric silently, and a declared name that did not occur
in the window reads 0.
"""

from __future__ import annotations

import importlib

from anibench.probes import Refused

MODULE = "pyani_plus_tpu_torch.utils.spans"
KEY = "program_spans"
# The runner's stages: the spans that no other runner span encloses (their
# top seconds) cover an iteration but for what runner.unspanned_s reads.
RUNNER = ("runner.md5", "runner.parse", "runner.genome_rows", "runner.load",
          "runner.compute", "runner.store", "runner.cache")  # fmt: skip


def install(probes) -> None:
    if KEY in probes.data:
        return
    try:
        spans = importlib.import_module(MODULE)
    except ImportError:
        return
    probes.replace(spans, "ON", lambda _off: True)
    probes.data[KEY] = {"totals": spans.totals(), "counters": spans.counters()}


def _growth(data: dict) -> tuple[dict, dict] | None:
    start = data.get(KEY)
    if start is None or not data["iterations"]:
        return None
    spans = importlib.import_module(MODULE)
    return start, {"totals": spans.totals(), "counters": spans.counters()}


def _declared(name: str) -> None:
    names = getattr(importlib.import_module(MODULE), "NAMES", None)
    if names is None or name not in names:
        raise Refused(f"a per-layer reader needs the program's span or counter {name!r}, "
                      f"which {MODULE} no longer declares")  # fmt: skip


def read(data: dict, name: str, field: str = "seconds") -> float | None:
    """The span ``name``'s ``field`` (``seconds``, ``self_seconds`` or
    ``top_seconds``) or the counter ``name`` (``field="count"``) over the
    window, an iteration."""
    both = _growth(data)
    if both is None:
        return None
    _declared(name)
    start, end = both
    if field == "count":
        grown = end["counters"].get(name, 0) - start["counters"].get(name, 0)
    else:
        before, after = start["totals"].get(name), end["totals"].get(name)
        grown = (getattr(after, field) if after else 0.0) - (getattr(before, field) if before else 0.0)
    return grown / len(data["iterations"])


def unspanned(data: dict) -> float | None:
    """Seconds an iteration spends outside every top-level runner span."""
    tops = [read(data, name, "top_seconds") for name in RUNNER]
    if any(t is None for t in tops):
        return None
    return sum(data["iterations"]) / len(data["iterations"]) - sum(tops)
