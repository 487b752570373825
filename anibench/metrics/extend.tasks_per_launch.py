"""Extension tasks a launch of B1 over the window (the growth of
``ops.extend.TASKS`` over that of ``ops.extend.LAUNCHES``, the program's
counters at the launch)."""


def install(probes) -> None:
    extend = probes.module("pyani_plus_tpu_torch.ops.extend")
    probes.counter(extend, "LAUNCHES", "extend_launches")
    probes.counter(extend, "TASKS", "extend_tasks")


def read(data: dict) -> float | None:
    if not data.get("extend_launches"):
        return None
    return data["extend_tasks"] / data["extend_launches"]
