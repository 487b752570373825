"""``runner.pairs_per_s`` in the ANIm cell, whose untraced runs spread
past what an end-to-end bound of 0.25, the most allowed, holds (PERF.md),
so that it holds its rate here, as sourmash and ANIb do: the same reading
as ``metrics/runner.pairs_per_s.py``, which this file loads."""

from pathlib import Path

from anibench.run import load_file

_SAME = load_file(Path(__file__).with_name("runner.pairs_per_s.py"), "anibench_metric_same_runner.pairs_per_s")
read = _SAME.read
if hasattr(_SAME, "install"):
    install = _SAME.install
