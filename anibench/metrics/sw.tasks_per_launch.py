"""Smith-Waterman tasks a launch of B2 over the window (the growth of
``ops.sw.TASKS`` over that of ``ops.sw.LAUNCHES``, the program's counters
at the launch)."""


def install(probes) -> None:
    sw = probes.module("pyani_plus_tpu_torch.ops.sw")
    probes.counter(sw, "LAUNCHES", "sw_launches")
    probes.counter(sw, "TASKS", "sw_tasks")


def read(data: dict) -> float | None:
    if not data.get("sw_launches"):
        return None
    return data["sw_tasks"] / data["sw_launches"]
