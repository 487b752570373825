"""Seconds an iteration in the runner's ingest on the slowest rank of a
process group, each of which ingests the whole collection: the top
seconds of the program's spans ``runner.md5`` (the MD5 index),
``runner.parse`` outside ``runner.load`` (the first parse of every FASTA)
and ``runner.genome_rows`` (the genome and run rows), the largest rank's."""

from anibench import program_spans, rank

install = program_spans.install
INGEST = ("runner.md5", "runner.parse", "runner.genome_rows")


def read(data: dict) -> float | None:
    seconds = rank.span_seconds(data, INGEST, "top_seconds")
    return None if seconds is None else max(seconds)
