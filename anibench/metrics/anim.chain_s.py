"""Thread-seconds an iteration in ANIm's chaining and gap fills, summed over
the pair threads: the program's span ``anim.chain`` around the
``_chain_and_fill`` map."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "anim.chain")
