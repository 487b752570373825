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


