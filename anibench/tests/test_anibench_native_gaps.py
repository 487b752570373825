"""The reader of ``anim.native_gaps``: a traced CPU run of the strains cell
at a tiny size reads the gaps that ANIm's native chain and gap fills
filled; a program that does not declare the counter (a checkout from
before it) and a program without the recorder give nothing to read, and
neither is refused."""

from __future__ import annotations

import sys

import pytest
import torch

from anibench import program_spans
from anibench.probes import Probes
from anibench.run import HERE, load_file, run_cell
from anibench.tests.conftest import tiny


@pytest.fixture
def reader():
    return load_file(HERE / "metrics" / "anim.native_gaps.py", "test_reader_anim_native_gaps")


def test_a_traced_strains_run_reads_the_gaps_filled():
    result = run_cell("anim_bact4.strains", 2**31 + 19, 0.5, True, card=False, overrides=tiny("ANIm"))
    assert result["correct"] is True
    assert result["metrics"]["anim.native_gaps"]["value"] > 0
    assert result["metrics"]["anim.native_gaps"]["unit"] == "gaps"


def _window(iterations: int = 1) -> dict:
    probes = Probes(torch)
    program_spans.install(probes)
    probes.close()
    return {**probes.data, "iterations": [1.0] * iterations}


def test_the_counter_over_the_window(reader):
    from pyani_plus_tpu_torch.utils import spans

    probes = Probes(torch)
    program_spans.install(probes)
    spans.count("anim.native_gaps", 30)
    probes.close()
    spans.count("anim.native_gaps", 7)  # after the window: off, not counted
    assert reader.read({**probes.data, "iterations": [1.0, 1.0]}) == 15.0


def test_a_program_before_the_counter_gives_nothing(reader, monkeypatch):
    from pyani_plus_tpu_torch.utils import spans

    data = _window()
    monkeypatch.setattr(spans, "NAMES", spans.NAMES - {"anim.native_gaps"})
    assert reader.read(data) is None


def test_a_program_without_the_recorder_gives_nothing(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.MODULE, None)  # its import fails
    assert reader.read(_window()) is None
