"""Seconds an iteration spends in the runner outside ingest and the
method: genome loading (the second parse), the store and the matrix
cache. An iteration's time less its ingest and method spans."""


def install(probes) -> None:
    runner = probes.module("pyani_plus_tpu_torch.parallel.runner")
    probes.span(runner, "index_fasta_directory", "ingest")
    probes.span(runner, "_setup_run", "ingest")
    probes.span(runner, "_compute", "compute")


def read(data: dict) -> float | None:
    spans, runs = data["spans"], data["iterations"]
    if "ingest" not in spans or "compute" not in spans or not runs:
        return None
    return (sum(runs) - spans["ingest"] - spans["compute"]) / len(runs)
