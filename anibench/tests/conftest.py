"""The benchmark's own tests: on the CPU, at sizes a test run holds.

The port runs on the CPU here only when asked (``PYANI_TPU_TORCH_DEVICE``,
which the repository's root ``conftest.py`` sets); the harness's look for
a card is skipped with ``card=False``, and the collections are cut with
``overrides``. Tests that need a card are marked ``gpu`` and skip without
one."""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def _cpu_and_tmp(monkeypatch, tmp_path):
    monkeypatch.setenv("PYANI_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    yield


def tiny(method: str) -> dict:
    """Collections the CPU runs in seconds: the ANIm cells' four genomes
    cut to 6 kb, or eight sourmash genomes of 20 kb in two clades."""
    if method == "ANIm":
        return {"length": 6000}
    return {"clades": 2, "per_clade": 4, "length": 20000}


GROUP = "anib_bact8_launch4.genus"
# the group cell at a size the CPU runs in seconds: four genomes of 6 kb
# over two ranks, each rank's share of the reference on two threads
GROUP_TINY = {"length": 6000, "per_clade": 4, "launch": 2}

_GROUP_SCRIPT = """
import json, os, signal, sys, time
from anibench import group, rank, run
stored = []
_read = group.read_rows
def _keep(db):
    rows = _read(db)
    stored.append([[q, s, row] for (q, s), row in rows.items()])
    return rows
group.read_rows = _keep
peers = []
_init = group.Peer.__init__
def _track(self, *args, **kwargs):
    _init(self, *args, **kwargs)
    peers.append(self)
group.Peer.__init__ = _track
{prelude}
t0 = time.monotonic()
result = run.run_cell({name!r}, {seed}, {seconds}, {trace}, card=False, overrides={overrides!r})
print(json.dumps({{"result": result, "stored": stored, "seconds": time.monotonic() - t0,
                  "left": [p.proc.pid for p in peers if p.proc.poll() is None]}}))
"""


def run_group(tmp_path, *, seed=2**31 + 7, seconds=1.0, trace=False, overrides=None, prelude="", hook=None) -> dict:
    """A run of the group cell as ``python -m anibench.run`` makes it, from
    a fresh interpreter, since rank 0 joins the program's process group
    for the life of its process. ``prelude`` runs in rank 0 before the run;
    ``hook`` is a ``sitecustomize`` for the other ranks. Returns the
    result, rank 0's stored rows of each iteration, the run's seconds and
    the PIDs of ranks left running."""
    import json
    import os
    import subprocess
    import sys

    from anibench.run import HERE

    env = {**os.environ, "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    if hook is not None:
        (tmp_path / "hook").mkdir()
        (tmp_path / "hook" / "sitecustomize.py").write_text(hook)
        env["PYTHONPATH"] = os.pathsep.join([str(tmp_path / "hook"), str(HERE.parent)])
    code = _GROUP_SCRIPT.format(prelude=prelude, name=GROUP, seed=seed, seconds=seconds, trace=trace,
                                overrides={**GROUP_TINY, **(overrides or {})})  # fmt: skip
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, env=env, capture_output=True, text=True,
                          timeout=300, check=False)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
