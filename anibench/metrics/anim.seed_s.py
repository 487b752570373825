"""Thread-seconds an iteration in ANIm's seeding, summed over the pair and
strand threads: the program's span ``anim.seed`` around the match
finders of ``align_sequences``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "anim.seed")
