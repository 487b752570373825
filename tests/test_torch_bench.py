"""The port's headline benchmark against the JAX package's ``bench.py``.

``python -m pyani_plus_tpu_torch.bench`` and ``bench.py`` run in
subprocesses on the CPU with the same small settings, and their JSON lines
are compared: the same counts give the same ``identity_mean`` (exactly)
and the same cliques, and the port's line holds every key of bench.py's
but ``extend_shape_buckets`` (the TPU kernel's compiled shapes, which the
CUDA kernel does not have). The genome generators are held to bench.py's
arrays; the scaling section, ``--warm-only`` and the refusal without a
card run on their own.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from pyani_plus_tpu_torch import bench as port_bench
from pyani_plus_tpu_torch.backend import ENV_DEVICE
from pyani_plus_tpu_torch.ops import sw

REPO = Path(__file__).resolve().parents[1]
PORT = [sys.executable, "-m", "pyani_plus_tpu_torch.bench"]
SMALL = {
    "BENCH_N": "40",
    "BENCH_LEN": "20000",
    "BENCH_REPS": "1",
    "BENCH_SCALING": "0",
    "BENCH_ALN_LEN": "20000",
    "BENCH_COL_QUERIES": "3",
    "BENCH_EXT_LANES": "16",
}
# bench.py's one key that the port leaves out
TPU_ONLY = {"extend_shape_buckets"}
EQUAL = ("classify_cliques", "fixture_max_abs_err", "unit", "timing_reps")
SCALING = (
    "scaling_n_processes",
    "scaling_pairs_per_sec",
    "scaling_wall_seconds",
    "scaling_startup_seconds",
    "scaling_efficiency_n2",
    "scaling_efficiency_n4",
    "scaling_host_cores",
    "scaling_efficiency",
)


def _load(name: str, path: Path):
    """A root-level script as a module (bench.py and chip_smoke.py import
    only numpy and the standard library at module level)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_bench():
    return _load("jax_bench", REPO / "bench.py")


def _run(cmd: list[str], env: dict[str, str], timeout: float = 300) -> subprocess.CompletedProcess:
    return subprocess.run(
        cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout, check=False
    )


def _line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _timed(key: str) -> bool:
    return key in ("value", "value_median") or key.endswith(
        ("_seconds", "_per_sec_device", "_per_sec_host", "_days_n1000", "_busy_fraction")
    )


@pytest.fixture(scope="module")
def lines() -> tuple[dict, dict]:
    """(bench.py's line, the port's line) at the same small settings."""
    base = {**os.environ, **SMALL}
    jax_env = {**base, "JAX_PLATFORMS": "cpu"}
    port_env = {**base, ENV_DEVICE: "cpu", "BENCH_FIXTURES": str(_jax_bench().FIXTURES)}
    with ThreadPoolExecutor(max_workers=2) as pool:
        jax_run = pool.submit(_run, [sys.executable, "bench.py"], jax_env)
        port_run = pool.submit(_run, PORT, port_env)
        return _line(jax_run.result()), _line(port_run.result())


def test_identity_mean_and_cliques_equal_bench_py(lines) -> None:
    jax_line, port_line = lines
    assert port_line["identity_mean"] == jax_line["identity_mean"]
    for key in EQUAL:
        assert port_line[key] == jax_line[key], key
    assert port_line["device_name"] is None
    assert port_line["device_power_limit"] is None


def test_keys_are_bench_pys_but_the_shape_ladder(lines) -> None:
    jax_line, port_line = lines
    assert TPU_ONLY <= set(jax_line)
    assert set(jax_line) - TPU_ONLY <= set(port_line)
    assert not TPU_ONLY & set(port_line)
    # the CPU request skips the device extension section and the device sketch
    assert "extend_lanes_per_sec_device" not in port_line
    assert "sketch_seconds_device_projected" not in port_line


def test_the_smokes_bench_keys_are_bench_pys(lines) -> None:
    """The key set the smoke's bench phase asks of the port's line on the
    card: bench.py's on an accelerator, ``extend_shape_buckets`` excepted."""
    jax_line, _ = lines
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    on_cpu = smoke.BENCH_PY_KEYS - set(smoke.BENCH_DEVICE_KEYS) - set(smoke.BENCH_SCALING_KEYS)
    assert on_cpu == set(jax_line) - TPU_ONLY
    assert set(smoke.BENCH_SCALING_KEYS) == set(SCALING)


def test_timed_fields_are_finite_and_spreads_bracket_their_medians(lines) -> None:
    _, port_line = lines
    timed = [key for key in port_line if _timed(key)]
    assert len(timed) > 20
    for key in timed:
        value = port_line[key]
        assert isinstance(value, (int, float)), key
        assert math.isfinite(value), key
        assert value >= 0, key
    spreads = [key for key in port_line if key.endswith("_spread")]
    assert len(spreads) == 9
    for key in spreads:
        lo, hi = port_line[key]
        assert lo <= port_line[key.removesuffix("_spread")] <= hi, key


@pytest.mark.parametrize(("n", "length", "seed"), [(3, 500, 0), (60, 1000, 0), (7, 2000, 5)])
def test_synth_genomes_equal_bench_py(n: int, length: int, seed: int) -> None:
    expected = _jax_bench().synth_genomes(n, length, seed)
    got = port_bench.synth_genomes(n, length, seed)
    assert len(got) == len(expected) == n
    for a, b in zip(got, expected):
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(("seed", "rate"), [(9, 0.15), (3, 0.12), (11, 0.5)])
def test_mutate_equals_bench_py(seed: int, rate: float) -> None:
    jax_bench = _jax_bench()
    codes = np.random.default_rng(seed).integers(0, 4, 5000, dtype=np.uint8)
    rng_jax, rng_port = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):  # the draws that follow must agree too
        expected = jax_bench.mutate(codes, rate, rng_jax)
        got = port_bench.mutate(codes, rate, rng_port)
        assert got.tobytes() == expected.tobytes()
    assert rng_port.random() == rng_jax.random()


def test_scaling_section_at_a_tiny_size() -> None:
    env = {
        **os.environ,
        ENV_DEVICE: "cpu",
        "BENCH_N": "40",
        "BENCH_LEN": "20000",
        "BENCH_REPS": "1",
        "BENCH_METHODS": "0",
        "BENCH_SCALING_N": "3",
        "BENCH_SCALING_LEN": "3000",
    }
    line = _line(_run(PORT, env))
    for key in SCALING:
        assert key in line, key
    assert line["scaling_n_processes"] == [1, 2, 4]
    for key in ("scaling_pairs_per_sec", "scaling_wall_seconds", "scaling_startup_seconds"):
        assert len(line[key]) == 3, key
        assert all(math.isfinite(v) and v >= 0 for v in line[key]), key
    assert line["scaling_efficiency"] in (line["scaling_efficiency_n2"], line["scaling_efficiency_n4"])
    assert "anim_column_pair_seconds" not in line


def test_refuses_without_a_card_or_the_cpu_request() -> None:
    env = {key: value for key, value in os.environ.items() if key != ENV_DEVICE}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run(PORT, {**env, **SMALL}, timeout=60)
    assert proc.returncode != 0
    assert ENV_DEVICE in proc.stderr
    assert "{" not in proc.stdout


def test_warm_only_on_the_cpu_warms_the_gram_alone() -> None:
    line = _line(_run([*PORT, "--warm-only"], {**os.environ, ENV_DEVICE: "cpu"}))
    assert line["mode"] == "warm-only"
    assert line["warm_gram_seconds"] >= 0
    assert set(line) == {"mode", "warm_gram_seconds"}


def test_warm_only_tasks_are_the_kernels_main_shapes() -> None:
    """``--warm-only`` launches B1 and B2 once each at their main shapes:
    B1's 512 tasks of 1,500-3,200 rows (every 8th 9,900), B2's 1,024
    fragments of 1,020 rows (every 16th shorter) in windows 300 wider."""
    rng = np.random.default_rng(0)
    tasks = port_bench.extension_tasks(rng, 512)
    assert len(tasks) == 512
    for i, (a, b) in enumerate(tasks):
        assert a.size == b.size
        assert a.size == 9900 if i % 8 == 0 else 1500 <= a.size < 3200
    fragments = port_bench.fragment_tasks(rng)
    assert len(fragments) == 1024
    for t, (q, s) in enumerate(fragments):
        assert q.dtype == s.dtype == np.uint8
        assert q.size == 1020 if t % 16 else 40 <= q.size < 1020
        assert s.size == q.size + 300
    # the homologous windows hold their fragment: B2 finds a real score
    scores = [score for score, _, _ in sw.batch_sw_best(fragments[:32], "cpu")]
    assert max(scores) > 1000
