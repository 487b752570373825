"""The port's copies of the JAX package's modules are copies.

fastANI, skani, ANIminimap2 and external-alignment run on the host in the
JAX package, and the port keeps its own copy of every module they use,
and of the skani debias simulation (``analysis/``, numpy only). It also
keeps verbatim copies of the store (``db/``), FASTA ingest
(``genomes/``, ``utils/``), the reports (``report/``) and three host ops
(``ops/chaining.py``, ``ops/dp.py``, ``ops/kmers.py``): the JAX package's
unit tests of those modules (``test_db``, ``test_db_orm``,
``test_classify``, ``test_plots_more``, ``test_genomes_ingest``,
``test_utils``, and the DP and chaining cases) hold the port's copies
too, as long as they stay copies.
Each copy equals its original once ``pyani_plus_tpu`` is read as
``pyani_plus_tpu_torch``; the C++ sources are byte for byte the same. In
``native/__init__.py`` only the loaders differ (the port builds through
``ops/_build.load_host_library``): every other function and class there
equals the original, and each ``_bind_<name>`` sets the argument types
that the original ``_load_<name>`` sets, but for the port's one addition:
``chain_and_fill_native``, whose library, ``band``, also took over the
consistent anchor chain DP from ``chain``, and the lane stream of the
suffix automaton and the MUM selection after it, ``_bind_sam_lanes``,
``sam_stream_ms_lanes_native`` and ``sam_select_mums_native``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "pyani_plus_tpu", REPO / "pyani_plus_tpu_torch"
MODULES = [
    "ops/minimizers.py",
    "ops/fastani_map.py",
    "ops/mm2.py",
    "methods/fastani.py",
    "methods/skani.py",
    "methods/animinimap2.py",
    "methods/external_alignment.py",
    "analysis/__init__.py",
    "analysis/skani_debias_sim.py",
    "db/__init__.py",
    "genomes/__init__.py",
    "utils/__init__.py",
    "report/__init__.py",
    "report/classify.py",
    "report/export.py",
    "report/plots.py",
    "ops/chaining.py",
    "ops/dp.py",
    "ops/kmers.py",
]
SOURCES = ["native/fastani.cpp", "native/mm2.cpp"]
# native/__init__.py: the original's loaders (and its in-place build),
# which the port replaces by _bound and one _bind_<name> each
LOADERS = {
    "_build": None,
    "_load": "_bind_sketch",
    "_load_align": "_bind_align",
    "_load_seedjoin": "_bind_seedjoin",
    "_load_suffix": "_bind_suffix",
    "_load_band": "_bind_band",
    "_load_mm2": "_bind_mm2",
    "_load_fastani": "_bind_fastani",
    "_load_chain": "_bind_chain",
}
# The port's own wrapper: ANIm's per-cluster chain and gap fills in one
# call (native/band.cpp's chain_and_fill), which the JAX package lacks.
# The consistent anchor chain DP it runs moved with it from the chain
# library to the band library: its binding and its wrapper's loader.
# And ANIm's matching-statistics stream in interleaved lanes
# (native/suffix.cpp's sam_stream_ms_lanes) and the MUM selection over its
# arrays (sam_select_mums): their binder and wrappers. The serial stream,
# its binding in _bind_sam and its wrapper stay copies, held to the
# originals below; the lane stream is held to them position for position
# by tests/test_torch_sam_lanes.py, the selection to the numpy selection
# it replaced by tests/test_torch_mum_index.py.
PORT_ONLY = {"chain_and_fill_native", "_bind_sam_lanes", "sam_stream_ms_lanes_native", "sam_select_mums_native"}
MOVED = "anchor_chain_dp"


def _as_port(text: str) -> str:
    return re.sub(r"\bpyani_plus_tpu\b", "pyani_plus_tpu_torch", text)


@pytest.mark.parametrize("module", MODULES)
def test_module_is_a_copy(module: str) -> None:
    assert (PORT / module).read_text() == _as_port((JAX / module).read_text())


@pytest.mark.parametrize("source", SOURCES)
def test_cpp_source_is_byte_identical(source: str) -> None:
    assert (PORT / source).read_bytes() == (JAX / source).read_bytes()


def _definitions(path: Path) -> dict[str, ast.AST]:
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _binds(node: ast.AST, symbol: str) -> bool:
    return f"lib.{symbol}." in ast.unparse(node)


def test_native_wrappers_are_copies_and_only_the_loaders_differ() -> None:
    jax, port = (_definitions(pkg / "native" / "__init__.py") for pkg in (JAX, PORT))
    assert set(jax) - set(port) == {"_build"}
    assert set(port) - set(jax) == {"_bound", *filter(None, LOADERS.values()), *PORT_ONLY}
    for name in sorted(set(jax) & set(port) - set(LOADERS)):
        if name == f"{MOVED}_native":  # the same wrapper on the band library
            expected = ast.unparse(jax[name]).replace("_load_chain()", "_load_band()")
            assert ast.unparse(port[name]) == expected, name
            continue
        assert ast.dump(port[name]) == ast.dump(jax[name]), name
    # the original: try: _build(...); lib = CDLL(...); <binding>; _x_lib = lib
    bindings = {
        binder: next(n for n in jax[loader].body if isinstance(n, ast.Try)).body[2:-1]
        for loader, binder in LOADERS.items()
        if binder is not None
    }
    chain = bindings["_bind_chain"]
    bindings["_bind_chain"] = [n for n in chain if not _binds(n, MOVED)]
    for loader, binder in LOADERS.items():
        if binder is None:
            continue
        binding, body = bindings[binder], port[binder].body
        if binder == "_bind_band":
            # the band library binds the moved DP as the chain library did,
            # then chain_and_fill, after the original's binding
            added, body = body[len(binding):], body[: len(binding)]
            moved = [ast.dump(n) for n in chain if _binds(n, MOVED)]
            assert [ast.dump(n) for n in added if _binds(n, MOVED)] == moved
            rest = [n for n in added if not _binds(n, MOVED)]
            local = {ast.dump(n) for n in chain if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}
            assert all(_binds(n, "chain_and_fill") or ast.dump(n) in local for n in rest)
            assert any(_binds(n, "chain_and_fill") for n in rest)
        assert [ast.dump(n) for n in body] == [ast.dump(n) for n in binding], binder
        # and the port's loader is _bound(name, _bind_<name>)
        (statement,) = port[loader].body
        assert ast.unparse(statement) == f"return _bound({binder.removeprefix('_bind_')!r}, {binder})"


@pytest.mark.parametrize("d_total", [0.01, 0.08])
def test_debias_simulation_gives_the_originals_numbers(d_total: float) -> None:
    """The copied simulation, driven from one seed through both packages,
    evolves the same genome and measures the same raw skani estimate."""
    import numpy as np

    from pyani_plus_tpu.analysis import skani_debias_sim as jax_sim
    from pyani_plus_tpu_torch.analysis import skani_debias_sim as port_sim

    codes = np.random.default_rng(3).integers(0, 4, 120_000).astype(np.uint8)
    derived, true_id = port_sim.evolve(codes, np.random.default_rng(9), d_total=d_total, n_inv=1)
    expected, expected_id = jax_sim.evolve(codes, np.random.default_rng(9), d_total=d_total, n_inv=1)
    assert np.array_equal(derived, expected) and true_id == expected_id
    assert port_sim.measure_raw(codes, derived) == jax_sim.measure_raw(codes, expected)
