"""The reader of ``anim.seed_candidates``: a traced CPU run of the strains
cell at a tiny size reads most of the plus strands' positions, of 16
pairs' two strands; over a window it reads the counter's growth an
iteration; a program that does not declare it (a checkout from before it)
and a program without the recorder give nothing to read, and neither is
refused."""

from __future__ import annotations

import sys

import pytest
import torch

from anibench import program_spans
from anibench.probes import Probes
from anibench.run import HERE, load_file, run_cell
from anibench.tests.conftest import tiny

NAME = "anim.seed_candidates"


@pytest.fixture
def reader():
    return load_file(HERE / "metrics" / f"{NAME}.py", "test_reader_seed_candidates")


def test_a_traced_strains_run_reads_the_candidates():
    result = run_cell("anim_bact4.strains", 2**31 + 29, 0.5, True, card=False, overrides=tiny("ANIm"))
    assert result["correct"] is True
    candidates = result["metrics"][NAME]
    assert candidates["unit"] == "positions" and 16 * 6000 / 2 < candidates["value"] < 32 * 6000


def _window() -> dict:
    probes = Probes(torch)
    program_spans.install(probes)
    probes.close()
    return {**probes.data, "iterations": [1.0]}


def test_the_counter_over_the_window(reader):
    from pyani_plus_tpu_torch.utils import spans

    probes = Probes(torch)
    program_spans.install(probes)
    spans.count(reader.NAME, 32)
    probes.close()
    spans.count(reader.NAME, 5)  # after the window: off, not counted
    assert reader.read({**probes.data, "iterations": [1.0, 1.0]}) == 16.0


def test_a_program_before_the_counter_gives_nothing(reader, monkeypatch):
    from pyani_plus_tpu_torch.utils import spans

    data = _window()
    monkeypatch.setattr(spans, "NAMES", spans.NAMES - {reader.NAME})
    assert reader.read(data) is None


def test_a_program_without_the_recorder_gives_nothing(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.MODULE, None)  # its import fails
    assert reader.read(_window()) is None
