"""Query positions an iteration that ANIm's lane stream streamed again:
the program's counter ``anim.seed_rewalked``, grown by the positions that
``native/suffix.cpp``'s ``sam_stream_ms_lanes`` re-walked to mend its
lanes' boundaries (most of a self-pair's query, a few dozen a boundary
elsewhere). A program from before the counter declares no such name and
gives nothing to read."""

import importlib

from anibench import program_spans

install = program_spans.install
NAME = "anim.seed_rewalked"


def read(data: dict) -> float | None:
    if program_spans.KEY not in data:
        return None
    if NAME not in getattr(importlib.import_module(program_spans.MODULE), "NAMES", ()):
        return None
    return program_spans.read(data, NAME, "count")
