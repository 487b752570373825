"""Seconds an iteration spends in the runner's ingest: the MD5 index of
the FASTA directory and ``_setup_run`` (the first parse of every FASTA,
the genome and run rows), from the benchmark's spans around the two."""


def install(probes) -> None:
    runner = probes.module("pyani_plus_tpu_torch.parallel.runner")
    probes.span(runner, "index_fasta_directory", "ingest")
    probes.span(runner, "_setup_run", "ingest")


def read(data: dict) -> float | None:
    if "ingest" not in data["spans"] or not data["iterations"]:
        return None
    return data["spans"]["ingest"] / len(data["iterations"])
