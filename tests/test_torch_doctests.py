"""Run the port's embedded doctests: the counterpart of tests/test_doctests.py.

The same eight modules as the JAX file, in the port, each with the JAX
file's minimum number of examples; and each module's number of examples
equal to its JAX original's (39 in all), so that an example dropped from a
copy shows. The JAX originals' examples are counted, not run: the JAX
file runs them.
"""

from __future__ import annotations

import doctest
import importlib
import importlib.util
from pathlib import Path

import pytest

# module of the port -> minimum number of doctest examples (tests/test_doctests.py)
MODULES = {
    "pyani_plus_tpu_torch.utils": 4,
    "pyani_plus_tpu_torch.genomes": 3,
    "pyani_plus_tpu_torch.ops.minhash": 1,
    "pyani_plus_tpu_torch.ops.fastani_map": 3,
    "pyani_plus_tpu_torch.ops.seeds": 1,
    "pyani_plus_tpu_torch.methods.anib": 1,
    "pyani_plus_tpu_torch.methods.skani": 1,
    "pyani_plus_tpu_torch.ops.mm2": 8,
}
TOTAL = 39


def _examples(module_name: str) -> int:
    module = importlib.import_module(module_name)
    return sum(len(test.examples) for test in doctest.DocTestFinder().find(module))


@pytest.mark.parametrize("module_name", sorted(MODULES))
def test_module_doctests(module_name: str) -> None:
    module = importlib.import_module(module_name)
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0, f"{module_name}: {results.failed} failures"
    assert results.attempted >= MODULES[module_name], (
        f"{module_name}: expected >= {MODULES[module_name]} doctest examples, found {results.attempted}"
    )
    original = module_name.replace("pyani_plus_tpu_torch", "pyani_plus_tpu", 1)
    assert results.attempted == _examples(original), f"{module_name} and {original} differ in examples"


def test_the_jax_files_modules_and_counts() -> None:
    """The same modules and minimum counts as tests/test_doctests.py, and
    the 39 examples in all."""
    spec = importlib.util.spec_from_file_location("jax_doctests", Path(__file__).with_name("test_doctests.py"))
    jax_file = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_file)
    assert {name.replace("pyani_plus_tpu", "pyani_plus_tpu_torch", 1): n
            for name, n in jax_file.MODULES.items()} == MODULES  # fmt: skip
    assert sum(_examples(name) for name in MODULES) == TOTAL
