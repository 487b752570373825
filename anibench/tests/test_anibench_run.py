"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped): the result line's keys, the spans and readers of a traced
run, and the refusals of ``python -m anibench.run``."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from anibench.run import HERE, run_cell
from anibench.tests.conftest import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line():
    result = run_cell("anim_bact4.strains", 2**31 + 99, 0.5, False, card=False, overrides=tiny("ANIm"))
    result.pop("_notes")
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result["setup_built"]) == {"built", "libraries"}
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {"pairs_per_s", "peak_host_gib", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == {"missing_rows", "null_mismatch", "count_gap", "identity_gap", "coverage_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())


STAGES = ("runner.ingest_s", "runner.rest_s", "method.compute_s", "device.idle_pct")


@pytest.mark.parametrize(("workload", "method", "layers"), [
    ("sourmash_bact128.clades", "sourmash", {"runner.pairs_per_s", *(f"{m}.sourmash" for m in STAGES)}),
    ("anim_bact4.strains", "ANIm", set(STAGES)),
])
def test_traced_run_reports_its_layers(workload, method, layers):
    result = run_cell(workload, 5, 0.5, True, card=False, overrides=tiny(method))
    assert result["correct"] is True
    assert layers <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0 for m in layers if not m.startswith("device."))
    assert "pairs_per_s" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # the wrappers are gone once the run ends
    from pyani_plus_tpu_torch.parallel import runner

    assert runner._compute.__module__ == "pyani_plus_tpu_torch.parallel.runner"


def test_sourmash_reports_its_rate_per_layer_only():
    result = run_cell("sourmash_bact128.clades", 2**31 + 98, 0.5, False, card=False, overrides=tiny("sourmash"))
    assert result["correct"] is True
    assert set(result["metrics"]) == {"peak_host_gib", "setup_s"}


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    proc = subprocess.run(
        [sys.executable, "-m", "anibench.run", "--workload", "anim_bact4.strains", "--seed", "1", "--seconds", "1"],
        cwd=HERE.parent, capture_output=True, text=True, timeout=120, check=False,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "anibench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "anibench.run", "--workload", "anim_bact4.strains", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, check=False,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card(monkeypatch):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.delenv("PYANI_TPU_TORCH_DEVICE")  # the port's own default: the card
    proc = subprocess.run(
        [sys.executable, "-m", "anibench.run", "--workload", "anim_bact4.strains", "--seed", "77", "--seconds", "1"],
        cwd=HERE.parent, capture_output=True, text=True, timeout=900, check=False,
    )
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and line["correct"] is True and line["device"]["platform"] == "gpu"
