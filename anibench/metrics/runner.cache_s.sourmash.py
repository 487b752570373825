"""``runner.cache_s`` in the cells that hold their rate per layer
(``runner.pairs_per_s``) and report ``peak_host_gib`` end to end: the
same reading as ``metrics/runner.cache_s.py``, which this file loads."""

from pathlib import Path

from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("runner.cache_s.py"), "anibench_metric_same_runner.cache_s")
read = _SAME.read
if hasattr(_SAME, "install"):
    install = _SAME.install
