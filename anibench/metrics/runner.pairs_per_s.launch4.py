"""``runner.pairs_per_s`` in the cell run as a process group: every pair
that rank 0 stores a second over the traced window, as
``metrics/runner.pairs_per_s.py`` reads it (this file loads it)."""

from pathlib import Path

from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("runner.pairs_per_s.py"), "anibench_metric_same_runner.pairs_per_s")
read = _SAME.read
