"""Nothing a run loads has the top-level name jax, jaxlib, flax or
pyani_plus_tpu (compared whole: the port's name begins with the JAX
package's), and the references load nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from anibench.run import HERE

FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'pyani_plus_tpu'}"


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True, text=True,
                          timeout=600, check=False)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import os, sys\n"
        f"os.environ['TMPDIR'] = {str(tmp_path)!r}\n"
        "from anibench.run import run_cell, forbidden_modules\n"
        "r = run_cell('anim_bact4.strains', 3, 0.2, True, card=False, overrides={'per_clade': 2, 'length': 5000})\n"
        "assert r['correct'], r\n"
        "print(forbidden_modules())\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN}))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[-3:-1] == ["[]", "[]"]


def test_the_references_load_nothing_of_the_port():
    code = (
        "import sys\n"
        "import anibench.reference.anim, anibench.reference.sourmash, anibench.judge, anibench.gen\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & ({FORBIDDEN} | {{'pyani_plus_tpu_torch'}})))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
