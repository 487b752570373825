"""``runner.ingest_s`` in the ANIb cell: the same reading as
``metrics/runner.ingest_s.py``, which this file loads."""

from pathlib import Path

from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("runner.ingest_s.py"), "anibench_metric_same_runner.ingest_s")
read = _SAME.read
if hasattr(_SAME, "install"):
    install = _SAME.install
