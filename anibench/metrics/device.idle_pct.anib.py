"""``device.idle_pct`` in the ANIb cell: the same reading as
``metrics/device.idle_pct.py``, which this file loads."""

from pathlib import Path

from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("device.idle_pct.py"), "anibench_metric_same_device.idle_pct")
read = _SAME.read
if hasattr(_SAME, "install"):
    install = _SAME.install
