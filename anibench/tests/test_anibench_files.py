"""Every file that BENCHMARK.json names is found by name and parses, and
the file keeps to the benchmark's contract on names and keys."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from anibench.run import HERE, load_file

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["anibench"]
    assert BENCH["command"] == ["python3", "-m", "anibench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    body = json.loads((HERE.parent / config["file"]).read_text())
    assert body["name"] == config["name"] and config["file"] == f"anibench/configs/{config['name']}.json"
    assert body["reduced"] == config["reduced"]
    for key in ("method", "params", "genomes", "genome_length", "assumed", "fields", "limits", "source"):
        assert key in body
    assert set(body["limits"]) >= {"missing_rows", "null_mismatch", "identity_gap"}
    method = body["method"].lower()
    for package in ("reference", "warmup"):
        module = importlib.import_module(f"anibench.{package}.{method}")
        assert callable(module.warm if package == "warmup" else module.compute)
    reference = importlib.import_module(f"anibench.reference.{method}")
    assert callable(reference.prepare) and callable(reference.rows)


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file(workload):
    assert set(workload) == {"name", "config", "traffic", "chips", "why"}
    assert workload["chips"] == 1 and len(workload["why"]) <= 200
    body = json.loads((HERE / "workloads" / f"{workload['name']}.json").read_text())
    assert body["config"] == workload["config"] and body["traffic"] == workload["traffic"]
    config = json.loads((HERE / "configs" / f"{workload['config']}.json").read_text())
    assert config["genomes"] % body["collection"]["clades"] == 0
    low, high = body["collection"]["rates"]
    assert 0 <= low <= high < 1


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    reader = load_file(HERE / "metrics" / f"{metric['name']}.py", f"test_reader_{metric['name']}")
    assert callable(reader.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_names_units_and_sources():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"])
        assert metric["better"] in ("lower", "higher")
    assert {m["source"] for m in BENCH["end_to_end"]} <= {"host_clock", "device_trace"}
    assert {"setup_s", "pairs_per_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    layers = {}
    for metric in BENCH["per_layer"]:
        assert metric["source"] in {"device_trace", "program_span", "program_counter", "host_clock"}
        layers.setdefault(metric["layer"], []).append(metric["name"])
    assert len(layers) == 5


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_its_layers_move(workload):
    def of_cell(metrics):
        return {m["name"]: m for m in metrics if workload["name"] in m.get("workloads", [workload["name"]])}

    end_to_end, per_layer = of_cell(BENCH["end_to_end"]), of_cell(BENCH["per_layer"])
    assert "setup_s" in end_to_end and len(end_to_end) >= 2 and per_layer
    assert {m["moves"] for m in per_layer.values()} <= set(end_to_end) - {"setup_s"}


def test_roofline_modules():
    for kernel in ("extend", "gram"):
        module = importlib.import_module(f"anibench.roofline.{kernel}")
        assert callable(module.least)


def test_no_file_outside_paths():
    for path in HERE.rglob("*"):
        assert Path(HERE.name, path.relative_to(HERE)).parts[0] == "anibench"
