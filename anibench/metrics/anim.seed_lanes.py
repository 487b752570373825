"""Lanes streamed an iteration by ANIm's seeding: the program's counter
``anim.seed_lanes``, grown by each query strand's lane count where
``native/suffix.cpp``'s ``sam_stream_ms_lanes`` streamed the automaton in
interleaved lanes (0 where every strand ran the serial loop). A program
from before the counter declares no such name and gives nothing to
read."""

import importlib

from anibench import program_spans

install = program_spans.install
NAME = "anim.seed_lanes"


def read(data: dict) -> float | None:
    if program_spans.KEY not in data:
        return None
    if NAME not in getattr(importlib.import_module(program_spans.MODULE), "NAMES", ()):
        return None
    return program_spans.read(data, NAME, "count")
