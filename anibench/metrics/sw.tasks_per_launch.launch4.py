"""Smith-Waterman tasks a launch of B2 over the window in a process group:
every rank's growth of ``ops.sw.TASKS`` over every rank's of
``ops.sw.LAUNCHES`` (installed as ``metrics/sw.tasks_per_launch.py``,
which this file loads, installs them on each rank)."""

from pathlib import Path

from anibench import rank
from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("sw.tasks_per_launch.py"), "anibench_metric_same_sw.tasks_per_launch")
install = _SAME.install


def read(data: dict) -> float | None:
    probes = rank.per_rank(data, "probes")
    if probes is None:
        return None
    launches = sum(p.get("sw_launches", 0) for p in probes)
    return sum(p.get("sw_tasks", 0) for p in probes) / launches if launches else None
