"""Thread-seconds an iteration in ANIm's 1-to-1 filter and scoring, summed
over the pair threads: the program's span ``anim.filter``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "anim.filter")
