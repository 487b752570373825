"""Seconds an iteration spends in the method (``runner._compute``: the
method's ``compute`` with its host stages and kernels), from the
benchmark's span around it."""


def install(probes) -> None:
    runner = probes.module("pyani_plus_tpu_torch.parallel.runner")
    probes.span(runner, "_compute", "compute")


def read(data: dict) -> float | None:
    if "compute" not in data["spans"] or not data["iterations"]:
        return None
    return data["spans"]["compute"] / len(data["iterations"])
