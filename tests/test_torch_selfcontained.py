"""The port is a package of its own: no ``jax``, nothing of ``pyani_plus_tpu``.

Two checks. A static one over every source file of the port, over
``chip_smoke.py`` and over the kernel-timing tools
(``tools/*_variants.py``): no import statement, and no module name
handed to ``importlib``, names ``jax`` or the JAX package. And a run: the port's
command line, in a subprocess whose import system refuses both names,
computes each ported method on tiny synthetic genomes on the CPU (with
the batched plain-PyTorch paths forced) and exports the run.
"""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest

from pyani_plus_tpu_torch.synthetic import write_alignment

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pyani_plus_tpu_torch"
# the port's sources, its smoke run and the tools that time its kernels
SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py",
              *(REPO / "tools").glob("*_variants.py")]
)  # fmt: skip
FOREIGN = ("jax", "jaxlib", "pyani_plus_tpu")
# the acceptance grep: an import statement at any indentation
IMPORT_LINE = re.compile(r"^\s*(from|import)\s+(pyani_plus_tpu|jax|jaxlib)([. ]|$)", re.M)
# a module path built for importlib
MODULE_STRING = re.compile(r"""["'](pyani_plus_tpu|jax|jaxlib)[."']""")


def _foreign(name: str | None) -> bool:
    return bool(name) and name.split(".")[0] in FOREIGN


def test_sources_were_found() -> None:
    assert len(SOURCES) > 30
    for expected in ("chip_smoke.py", "tools/sw_variants.py", "tools/extend_variants.py",
                     "pyani_plus_tpu_torch/native/__init__.py",
                     "pyani_plus_tpu_torch/db/__init__.py",
                     "pyani_plus_tpu_torch/report/classify.py",
                     *(f"pyani_plus_tpu_torch/{m}.py" for m in (
                         "ops/minimizers", "ops/fastani_map", "ops/mm2", "methods/fastani",
                         "methods/skani", "methods/animinimap2", "methods/external_alignment",
                         "parallel/distributed", "parallel/tiles", "analysis/skani_debias_sim"))):  # fmt: skip
        assert expected in SOURCES


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_nothing_of_jax_or_the_jax_package(source: str) -> None:
    text = (REPO / source).read_text()
    assert not IMPORT_LINE.search(text), IMPORT_LINE.search(text).group(0)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            assert not any(_foreign(alias.name) for alias in node.names), ast.dump(node)
        elif isinstance(node, ast.ImportFrom):
            assert node.level > 0 or not _foreign(node.module), ast.dump(node)
        elif isinstance(node, ast.Call) and "import" in ast.dump(node.func).lower():
            for arg in node.args:  # importlib.import_module("...") and f-strings of it
                literal = ast.unparse(arg)
                assert not MODULE_STRING.search(literal), literal


# Refuses any import of jax or of the JAX package, wherever it comes from.
IMPORT_HOOK = """
import sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"):
            raise ImportError("refused in this test: " + name)
sys.meta_path.insert(0, _Refuse())
try:
    import pyani_plus_tpu
except ImportError:
    pass
else:
    raise SystemExit("the import hook does not refuse pyani_plus_tpu")
"""

CLI_RUN = IMPORT_HOOK + """
from click.testing import CliRunner
from pyani_plus_tpu_torch.cli.main import app
command, fasta, db, cache, out = sys.argv[1:6]
for args in ([command, fasta, "-d", db, "--create-db", "--cache", cache, *sys.argv[6:]],
             ["export-run", "-d", db, "-o", out]):
    result = CliRunner().invoke(app, args, catch_exceptions=False)
    if result.exit_code != 0:
        raise SystemExit(result.output)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"))
print("LOADED", loaded)
"""


@pytest.fixture(scope="module")
def tiny_genomes(tmp_path_factory) -> Path:
    directory = tmp_path_factory.mktemp("tiny_genomes")
    write_alignment(directory, 15_000, [0.01, 0.04], seed=17)  # genomes.aln beside them
    return directory


@pytest.mark.parametrize(
    ("command", "method", "options", "floor"),
    [
        ("anim", "ANIm", [], 0.6),
        ("dnadiff", "dnadiff", [], 0.6),
        ("anib", "ANIb", [], 0.6),
        # a sketch of 15 kb needs a denser sampling than the default
        ("sourmash", "sourmash", ["--scaled", "20", "-k", "21"], 0.6),
        ("fastani", "fastANI", [], 0.6),
        ("skani", "skani", [], 0.6),
        # (the JAX package's ANIminimap2 reports about half the identity here)
        ("animinimap2", "ANIminimap2", [], 0.3),
        ("external-alignment", "external-alignment", ["--alignment", "genomes.aln"], 0.6),
    ],
    ids=["anim", "dnadiff", "anib", "sourmash", "fastani", "skani", "animinimap2",
         "external-alignment"],
)
def test_cli_runs_with_jax_and_the_jax_package_refused(  # noqa: PLR0913
    command: str, method: str, options: list[str], floor: float, tiny_genomes: Path,
    tmp_path: Path,
) -> None:
    env = {
        **os.environ,
        "PYANI_TPU_EXTEND_BATCH_MIN": "1",  # the batched extension path
        "PYANI_TPU_ANIB_DEVICE": "1",  # the batched Smith-Waterman path
        "OMP_NUM_THREADS": "1",  # row-serial small tensors
        "PYTHONPATH": os.pathsep.join(
            [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]
        ),
    }
    out = tmp_path / "out"
    options = [str(tiny_genomes / o) if o.endswith(".aln") else o for o in options]
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUN, command, str(tiny_genomes),
         str(tmp_path / "ani.db"), str(tmp_path / "cache"), str(out), *options],
        capture_output=True, text=True, env=env, timeout=600, check=False,
    )  # fmt: skip
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    identity = pd.read_csv(out / f"{method}_identity.tsv", sep="\t", index_col=0)
    assert identity.shape == (2, 2)
    values = identity.to_numpy()
    # (ANIm counts the N runs and IUPAC letters of a genome against itself)
    assert (values.diagonal() > 0.95).all()
    assert ((values > floor) & (values <= 1.0)).all()
    assert values[0, 1] < values.diagonal().min()
    assert len(list(out.glob("*.tsv"))) == 7
