"""The readers of the program's own spans and counters
(``anibench/program_spans.py``): traced CPU runs of each cell at a tiny
size, in which every one of them reads a number; a program without the
recorder, of which they read nothing and refuse nothing; a program that
no longer declares a name, which they refuse."""

from __future__ import annotations

import functools
import sys

import pytest
import torch

from anibench import program_spans
from anibench.probes import Probes, Refused
from anibench.run import run_cell
from anibench.tests.conftest import tiny

RUNNER = ["runner.md5_s", "runner.parse_s", "runner.genome_rows_s", "runner.load_s", "runner.store_s",
          "runner.cache_s", "runner.unspanned_s", "runner.parses"]  # fmt: skip
STRAINS = [*RUNNER, "anim.seed_s", "anim.cluster_s", "anim.chain_s", "anim.extend_s", "anim.filter_s",
           "extend.wait_s"]  # fmt: skip
SOURMASH = [*(f"{m}.sourmash" for m in RUNNER), "sourmash.sketch_s", "sourmash.sketches", "gram.prepare_s",
            "gram.device_s"]  # fmt: skip


@pytest.fixture
def every_stage(monkeypatch):
    """What the cells do at their size, here at a tiny one: sourmash's
    counts from the device Gram (by itself at 64 genomes and 2^18 hashes),
    ANIm's extensions through submit and collect (on the card by itself),
    there on the native host kernel, the plain version's oracle."""
    from pyani_plus_tpu_torch.methods import sourmash
    from pyani_plus_tpu_torch.ops import extend, minhash

    monkeypatch.setattr(sourmash, "containment_ani", functools.partial(minhash.containment_ani, use_device=True))
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", "1")
    monkeypatch.setattr(extend, "batch_extend_reference", extend.batch_extend_host)


@pytest.mark.parametrize(("workload", "method", "new", "suffix", "genomes"), [
    ("sourmash_bact128.clades", "sourmash", SOURMASH, ".sourmash", 8),
    ("anim_bact4.strains", "ANIm", STRAINS, "", 4),
])  # fmt: skip
def test_every_new_metric_reads(workload, method, new, suffix, genomes, every_stage):
    result = run_cell(workload, 2**31 + 11, 0.5, True, card=False, overrides=tiny(method))
    assert result["correct"] is True
    metrics = {name: m["value"] for name, m in result["metrics"].items()}
    missing = [name for name in new if name not in metrics]
    assert not missing, missing
    assert metrics[f"runner.parses{suffix}"] == 2 * genomes
    assert all(metrics[name] >= 0 for name in new)
    # the inner spans lie inside the outer probes: the MD5 index, the first
    # parse (both parses less the second, which runner.load holds) and the
    # genome rows inside ingest, the method's stages inside compute
    first_parse = metrics[f"runner.parse_s{suffix}"] - metrics[f"runner.load_s{suffix}"]
    inner = metrics[f"runner.md5_s{suffix}"] + first_parse + metrics[f"runner.genome_rows_s{suffix}"]
    assert 0 < inner <= metrics[f"runner.ingest_s{suffix}"]
    assert metrics[f"runner.unspanned_s{suffix}"] <= metrics[f"runner.rest_s{suffix}"]
    if method == "sourmash":
        assert metrics["sourmash.sketches"] == genomes  # each iteration starts with an empty cache
        stages = metrics["sourmash.sketch_s"] + metrics["gram.prepare_s"] + metrics["gram.device_s"]
        assert 0 < stages <= metrics["method.compute_s.sourmash"]
        assert metrics["gram.device_s"] == 0  # a CPU mesh holds no card: no batch of the card
    from pyani_plus_tpu_torch.utils import spans

    assert spans.ON is False  # the window's end switched the recorder off again


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.MODULE, None)  # its import fails
    probes = Probes(torch)
    program_spans.install(probes)
    probes.close()
    data = {**probes.data, "iterations": [1.0]}
    assert program_spans.KEY not in data
    assert program_spans.read(data, "runner.md5") is None
    assert program_spans.unspanned(data) is None


def test_install_switches_the_recorder_for_the_window_only():
    from pyani_plus_tpu_torch.utils import spans

    spans.reset()
    probes = Probes(torch)
    program_spans.install(probes)
    program_spans.install(probes)  # a second reader asking for it
    assert spans.ON is True
    with spans.span("runner.md5"):
        spans.count("runner.parses", 4)
    probes.close()
    assert spans.ON is False
    with spans.span("runner.md5"):  # after the window: off, not recorded
        spans.count("runner.parses", 4)
    data = {**probes.data, "iterations": [1.0, 1.0]}
    assert program_spans.read(data, "runner.parses", "count") == 2.0
    seconds = program_spans.read(data, "runner.md5")
    assert seconds is not None and 0 <= seconds < 1
    # declared, but not in the window: 0
    assert program_spans.read(data, "runner.store") == 0.0
    assert program_spans.read(data, "sourmash.sketches", "count") == 0.0


@pytest.mark.parametrize("name", ["runner.nothing", "runner.md5"])
def test_a_name_the_program_no_longer_declares_is_refused(name, monkeypatch):
    from pyani_plus_tpu_torch.utils import spans

    probes = Probes(torch)
    program_spans.install(probes)
    probes.close()
    monkeypatch.setattr(spans, "NAMES", spans.NAMES - {"runner.md5"})
    data = {**probes.data, "iterations": [1.0]}
    with pytest.raises(Refused, match=name):
        program_spans.read(data, name)
    with pytest.raises(Refused, match="runner.md5"):
        program_spans.unspanned(data)
