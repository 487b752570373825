"""Gaps filled an iteration by ANIm's native chain and gap fills: the
program's counter ``anim.native_gaps``, grown once a cluster by the gaps
that ``native/band.cpp``'s ``chain_and_fill`` filled in one call outside
the interpreter lock (0 where the Python fallback filled them). A
program from before the counter declares no such name and gives nothing
to read."""

import importlib

from anibench import program_spans

install = program_spans.install
NAME = "anim.native_gaps"


def read(data: dict) -> float | None:
    if program_spans.KEY not in data:
        return None
    if NAME not in getattr(importlib.import_module(program_spans.MODULE), "NAMES", ()):
        return None
    return program_spans.read(data, NAME, "count")
