"""Query positions an iteration that ANIm's MUM selection took in: the
program's counter ``anim.seed_candidates``, grown by the candidates (a
match of at least the minimum length with a unique ref start) that
``native/suffix.cpp``'s ``sam_select_mums`` turned into MUMs, on both
strands (almost every plus-strand position of a strains pair). A program
from before the counter declares no such name and gives nothing to
read."""

import importlib

from anibench import program_spans

install = program_spans.install
NAME = "anim.seed_candidates"


def read(data: dict) -> float | None:
    if program_spans.KEY not in data:
        return None
    if NAME not in getattr(importlib.import_module(program_spans.MODULE), "NAMES", ()):
        return None
    return program_spans.read(data, NAME, "count")
