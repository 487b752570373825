"""The port's synthetic inputs against the root ``bench.py``'s draws.

``synthetic.substitute`` is the root ``bench.py``'s ``mutate``: the same
codes and the same draws from the generator, so that
``synthetic.extension_tasks`` gives B1 the main shape that bench.py's
extension section times.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from pyani_plus_tpu_torch import synthetic

REPO = Path(__file__).resolve().parents[1]


def _jax_bench():
    """The root bench.py as a module (it imports only numpy and the
    standard library at module level)."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(("seed", "rate"), [(9, 0.15), (3, 0.12), (11, 0.5)])
def test_substitute_equals_bench_pys_mutate(seed: int, rate: float) -> None:
    jax_bench = _jax_bench()
    codes = np.random.default_rng(seed).integers(0, 4, 5000, dtype=np.uint8)
    rng_jax, rng_port = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):  # the draws that follow must agree too
        expected = jax_bench.mutate(codes, rate, rng_jax)
        got = synthetic.substitute(codes, rate, rng_port)
        assert got.tobytes() == expected.tobytes()
    assert rng_port.random() == rng_jax.random()
