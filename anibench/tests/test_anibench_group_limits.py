"""A rank that is killed or stalls during the window ends a group run
within its limit: rank 0 kills every other rank by its PID, leaves none
running, and reports the run as not correct with the error."""

from __future__ import annotations

import pytest

from anibench.tests.conftest import run_group

# rank 0 does this to rank 1 as it starts its own second iteration
AT_SECOND_ITERATION = """
_iterate = rank.Member.iterate
def _at(self, k):
    if k == 1:
        os.kill(peers[0].proc.pid, signal.{signal})
    return _iterate(self, k)
rank.Member.iterate = _at
"""


@pytest.mark.parametrize(("sig", "error"), [("SIGKILL", "rank 1 exited"), ("SIGSTOP", "a rank stalled")])
def test_a_lost_rank_ends_the_run(tmp_path, sig, error):
    seconds = 4.0  # the second iteration begins inside the window on a loaded host too
    out = run_group(tmp_path, seconds=seconds, overrides={"launch": 3},
                    prelude=AT_SECOND_ITERATION.format(signal=sig))  # fmt: skip
    result, notes = out["result"], out["result"]["_notes"]
    assert result["correct"] is False
    assert error in notes["error"]
    assert len(notes["iterations_s"]) == 1 and result["failed"] > 0  # the second iteration stored nothing whole
    assert out["left"] == []
    # the window (the first iteration began before it closed), then at most the limit
    assert out["seconds"] - notes["setup_s"] < seconds + notes["limit_s"] + 15


def test_the_group_refuses_without_its_cards(monkeypatch):
    import subprocess
    import sys

    from anibench.run import HERE
    from anibench.tests.conftest import GROUP

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    proc = subprocess.run(
        [sys.executable, "-m", "anibench.run", "--workload", GROUP, "--seed", "1", "--seconds", "1"],
        cwd=HERE.parent, capture_output=True, text=True, timeout=120, check=False,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs 4 CUDA card(s)" in proc.stderr


_WITHOUT_THE_PROGRAM = """
from anibench import group, run
peers = []
_init = group.Peer.__init__
def _track(self, *args, **kwargs):
    _init(self, *args, **kwargs)
    peers.append(self)
group.Peer.__init__ = _track
try:
    run.run_cell({name!r}, 5, 1.0, False, card=False, overrides={overrides!r})
except run.Refused as err:
    print("refused:", err)
print("left:", [p.proc.pid for p in peers if p.proc.poll() is None])
"""


def test_the_group_refuses_without_the_program(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the benchmark,
    a group run is refused (no result), with every rank stopped."""
    import os
    import shutil
    import subprocess
    import sys

    from anibench.run import HERE
    from anibench.tests.conftest import GROUP, GROUP_TINY

    bare = tmp_path / "bare"
    shutil.copytree(HERE, bare / "anibench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", bare)
    code = _WITHOUT_THE_PROGRAM.format(name=GROUP, overrides=GROUP_TINY)
    proc = subprocess.run([sys.executable, "-c", code], cwd=bare, env={**os.environ, "TMPDIR": str(tmp_path)},
                          capture_output=True, text=True, timeout=120, check=False)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "refused: the program does not import here" in proc.stdout
    assert "left: []" in proc.stdout
