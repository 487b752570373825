"""B2's share of its roofline over the window: the least time of the tasks
handed to it (``roofline/sw.py``) over the summed device time of the
profiler's ``sw_kernel`` events, in percent.

The probe wraps ANIb's ``batch_sw_best_submit``/``batch_sw_best_collect``
and records each task's fragment and window lengths once its batch has
been collected."""

from anibench.roofline import sw


def install(probes) -> None:
    anib = probes.module("pyani_plus_tpu_torch.methods.anib")
    tasks = probes.data.setdefault("sw_task_sizes", [])
    pending: dict[int, list[tuple[int, int]]] = {}

    def submit(real):
        def sub(batch, *args, **kwargs):
            parts = real(batch, *args, **kwargs)
            with probes.lock:
                pending[id(parts)] = [(q.size, s.size) for q, s in batch]
            return parts

        return sub

    def collect(real):
        def col(parts):
            results = real(parts)
            with probes.lock:
                tasks.extend(pending.pop(id(parts), []))
            return results

        return col

    probes.replace(anib, "batch_sw_best_submit", submit)
    probes.replace(anib, "batch_sw_best_collect", collect)


def read(data: dict) -> float | None:
    kernel_s = sum(t for name, t in data["timeline"]["kernel_s"].items() if "sw_kernel" in name)
    if not data.get("sw_task_sizes") or kernel_s <= 0:
        return None
    least_s, _by = sw.least(data["sw_task_sizes"])
    return 100.0 * least_s / kernel_s
