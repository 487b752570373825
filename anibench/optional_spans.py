"""The program's spans and counters that a program from before them does
not declare (ANIb's, ``anib.*`` and ``sw.wait``): read as
``program_spans.read`` reads them, but a name the program does not
declare gives nothing to read (None, the metric left out of the line),
where ``program_spans`` refuses it, so that a checkout from before the
spans runs the cell's traced runs all the same."""

from __future__ import annotations

import importlib

from anibench import program_spans

install = program_spans.install


def read(data: dict, name: str, field: str = "seconds") -> float | None:
    if program_spans.KEY not in data:
        return None
    if name not in getattr(importlib.import_module(program_spans.MODULE), "NAMES", ()):
        return None
    return program_spans.read(data, name, field)
