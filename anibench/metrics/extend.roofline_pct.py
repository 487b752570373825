"""B1's share of its roofline over the window: the least time of the
tasks handed to it (``roofline/extend.py``) over the summed device time
of the profiler's ``extend_kernel`` events, in percent.

The probe wraps ANIm's ``batch_extend_submit``/``batch_extend_collect``
and records each task's rows and columns with the rows its result
advanced to the best cell."""

from anibench.roofline import extend


def install(probes) -> None:
    anim = probes.module("pyani_plus_tpu_torch.methods.anim")
    tasks = probes.data.setdefault("extend_task_sizes", [])
    pending: dict[int, list[tuple[int, int]]] = {}

    def submit(real):
        def sub(batch, *args, **kwargs):
            state = real(batch, *args, **kwargs)
            with probes.lock:
                pending[id(state)] = [(a.size, b.size) for a, b in batch]
            return state

        return sub

    def collect(real):
        def col(state):
            results = real(state)
            with probes.lock:
                sizes = pending.pop(id(state), [])
                tasks.extend((m, n, r[0]) for (m, n), r in zip(sizes, results))
            return results

        return col

    probes.replace(anim, "batch_extend_submit", submit)
    probes.replace(anim, "batch_extend_collect", collect)


def read(data: dict) -> float | None:
    kernel_s = sum(t for name, t in data["timeline"]["kernel_s"].items() if "extend_kernel" in name)
    if not data.get("extend_task_sizes") or kernel_s <= 0:
        return None
    least_s, _by = extend.least(data["extend_task_sizes"])
    return 100.0 * least_s / kernel_s
