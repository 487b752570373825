"""The one packer of both kernels (``ops/_tasks.pack_tasks``), on the CPU.

B1 packs its tasks longest first (``ops/extend.launch_order``), B2 in the
caller's order. For each, over seven task sets (an empty batch, tasks
that are all empty, one task, a fuzz set, the unit edge set, tasks past
the kernel's width rule and the main shape), the six views give back
every task's codes, lengths and offsets in the kernel's order, in one
buffer, and the fragment section holds ``sum(m)`` bytes: ``a_all``, whose
size sets B2's scratch rows, spans it and the spare byte, not the windows.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pyani_plus_tpu_torch import synthetic
from pyani_plus_tpu_torch.ops import extend as ext
from pyani_plus_tpu_torch.ops._tasks import PACKED_DTYPES, pack_tasks

REPO = Path(__file__).resolve().parents[1]
EMPTY = np.zeros(0, np.uint8)


def _smoke():
    """chip_smoke.py as a module (numpy and the standard library only at
    module level), for B2's main shape."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _past_the_rule(kernel: str) -> list:
    if kernel == "sw":  # the last task of the packed 16-bit lanes and the first of the 32-bit words
        return synthetic.sw_rule_edge_tasks(5)
    rng = np.random.default_rng(5)  # m + n at 65,535 and past it: 16-bit and 32-bit payload fields
    return [(rng.integers(0, 4, m).astype(np.uint8), rng.integers(0, 4, n).astype(np.uint8))
            for m, n in ((65_000, 535), (65_000, 536), (300, 70_000))]  # fmt: skip


SETS = {
    "empty": lambda kernel: [],
    "all_empty": lambda kernel: [(EMPTY, EMPTY)] * 3,
    "one": lambda kernel: (synthetic.extension_fuzz_tasks(3, 1, 400) if kernel == "extend"
                           else synthetic.sw_trim_fuzz_tasks(3, 1)),  # fmt: skip
    "fuzz": lambda kernel: (synthetic.extension_fuzz_tasks(41, 20, 1100) if kernel == "extend"
                            else synthetic.sw_iupac_fuzz_tasks()),  # fmt: skip
    "edge": lambda kernel: [task for group in (synthetic.extension_edge_tasks(7) if kernel == "extend"
                                               else synthetic.sw_edge_tasks(7, rule_edge=False)).values()
                            for task in group],  # fmt: skip
    "past_the_rule": _past_the_rule,
    "main": lambda kernel: (synthetic.extension_tasks(np.random.default_rng(9), 512) if kernel == "extend"
                            else _smoke().sw_main_tasks(np.random.default_rng(9))),  # fmt: skip
}


@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("kernel", ["extend", "sw"])
def test_the_views_give_back_every_task_in_the_kernels_order(kernel: str, name: str) -> None:
    tasks = SETS[name](kernel)
    nb = len(tasks)
    if kernel == "extend":
        order = ext.launch_order(tasks)
        packed = pack_tasks(tasks, order)
    else:
        order = np.arange(nb)
        packed = pack_tasks(tasks)
    ordered = [tasks[t] for t in order]
    a_bytes = sum(a.size for a, _ in tasks)
    b_bytes = sum(b.size for _, b in tasks)
    buf = packed.buf
    assert (packed.count, packed.a_bytes) == (nb, a_bytes)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    assert buf.numel() == 24 * nb + a_bytes + b_bytes + 1
    views = packed.views()
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    for view, dtype in zip(views, PACKED_DTYPES):  # one buffer: one copy moves them all
        assert view.dtype == dtype and view.dim() == 1 and view.is_contiguous()
        if view.numel():  # an empty view has no address (the kernels launch nothing then)
            assert lo <= view.data_ptr() and view.data_ptr() + view.numel() * view.element_size() <= hi
    a_all, b_all, a_off, b_off, m, n = (v.numpy() for v in views)
    assert a_all.size == a_bytes + 1  # the fragment section and the spare byte
    assert m.tolist() == [a.size for a, _ in ordered] and n.tolist() == [b.size for _, b in ordered]
    assert a_off.tolist() == np.concatenate([[0], np.cumsum(m[:-1])]).astype(int).tolist()[:nb]
    assert b_off.tolist() == (a_bytes + np.concatenate([[0], np.cumsum(n[:-1])])).astype(int).tolist()[:nb]
    for p, (a, b) in enumerate(ordered):
        assert a_all[a_off[p] : a_off[p] + m[p]].tobytes() == np.asarray(a, np.uint8).tobytes()
        assert b_all[b_off[p] : b_off[p] + n[p]].tobytes() == np.asarray(b, np.uint8).tobytes()
    if kernel == "extend":
        assert all(m[:-1] >= m[1:])  # longest first
