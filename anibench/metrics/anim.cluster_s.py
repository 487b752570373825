"""Thread-seconds an iteration in ANIm's clustering of the matches, summed
over the strand threads: the program's span ``anim.cluster``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "anim.cluster")
