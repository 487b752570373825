"""The probes that per-layer readers install: shared between readers,
undone when the window closes, and refused where the program no longer
has the name a reader asks for."""

from __future__ import annotations

import types

import pytest
import torch

from anibench.probes import Probes, Refused
from anibench.run import new_files


def _module():
    module = types.ModuleType("program_stub")
    module.work = lambda x: x + 1
    module.COUNT = 3
    return module


def test_a_span_is_installed_once_and_undone():
    module, probes = _module(), Probes(torch)
    real = module.work
    probes.span(module, "work", "compute")
    wrapped = module.work
    probes.span(module, "work", "compute")  # a second reader asking for it
    assert module.work is wrapped and module.work(1) == 2
    probes.close()
    assert module.work is real
    assert probes.data["spans"]["compute"] > 0


def test_replacements_stack_and_unwind():
    module, probes = _module(), Probes(torch)
    real = module.work
    probes.replace(module, "work", lambda f: lambda x: f(x) * 10)
    probes.replace(module, "work", lambda f: lambda x: f(x) + 5)
    assert module.work(1) == 25
    probes.close()
    assert module.work is real


def test_a_counter_reads_its_growth():
    module, probes = _module(), Probes(torch)
    probes.counter(module, "COUNT", "count")
    module.COUNT += 5
    probes.close()
    assert probes.data["count"] == 5


@pytest.mark.parametrize("ask", [
    lambda p, m: p.span(m, "renamed", "compute"),
    lambda p, m: p.counter(m, "GONE", "gone"),
    lambda p, m: p.replace(m, "missing", lambda real: real),
    lambda p, _m: p.module("pyani_plus_tpu_torch.no_such_module"),
])
def test_a_missing_name_is_refused(ask):
    with pytest.raises(Refused):
        ask(Probes(torch), _module())


def test_every_reader_installs_against_the_program():
    import json

    from anibench.run import HERE, load_file

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    probes = Probes(torch)
    try:
        for metric in bench["per_layer"]:
            reader = load_file(HERE / "metrics" / f"{metric['name']}.py", f"probe_test_{metric['name']}")
            if hasattr(reader, "install"):
                reader.install(probes)
    finally:
        probes.close()
    from pyani_plus_tpu_torch.parallel import runner

    assert runner._compute.__module__ == "pyani_plus_tpu_torch.parallel.runner"


def test_libraries_built_during_set_up_are_named():
    before = {"_build/a.so": 1, "_build/b.so": 2}
    after = {"_build/a.so": 1, "_build/b.so": 5, "_build/c.so": 9}
    assert new_files(before, after) == ["_build/b.so", "_build/c.so"]
    assert new_files(after, after) == []
