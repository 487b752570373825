"""``method.compute_s`` in the ANIb cell: the same reading as
``metrics/method.compute_s.py``, which this file loads."""

from pathlib import Path

from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("method.compute_s.py"), "anibench_metric_same_method.compute_s")
read = _SAME.read
if hasattr(_SAME, "install"):
    install = _SAME.install
