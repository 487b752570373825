"""Ragged (a, b) code tasks as flat buffers, the layout every kernel takes.

A batch of tasks becomes two uint8 buffers (all a's, all b's, back to
back), int64 start offsets into each and int32 lengths: no padding, so
tasks of any length share one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from pyani_plus_tpu_torch import backend

Task = tuple[np.ndarray, np.ndarray]

PACKED_DTYPES = (
    torch.uint8, torch.uint8, torch.int64, torch.int64, torch.int32, torch.int32
)


def pack_tasks(
    tasks: list[Task], *, pin_memory: bool = False
) -> tuple[torch.Tensor, ...]:
    """Ragged tasks as flat CPU tensors: (a_all, b_all) uint8 codes,
    (a_off, b_off) int64 start offsets and (m, n) int32 lengths.

    ``pin_memory`` packs into page-locked memory, so that a copy to the
    card with ``non_blocking=True`` neither waits for the stream nor
    blocks the host.
    """
    m = np.array([a.size for a, _ in tasks], dtype=np.int32)
    n = np.array([b.size for _, b in tasks], dtype=np.int32)
    a_off = np.zeros(len(tasks), dtype=np.int64)
    b_off = np.zeros(len(tasks), dtype=np.int64)
    a_off[1:] = np.cumsum(m[:-1], dtype=np.int64)
    b_off[1:] = np.cumsum(n[:-1], dtype=np.int64)
    # a spare byte keeps each buffer non-empty when every task is empty
    spare = np.zeros(1, np.uint8)
    out = []
    for parts in (
        [*(np.asarray(a, np.uint8) for a, _ in tasks), spare],
        [*(np.asarray(b, np.uint8) for _, b in tasks), spare],
    ):
        size = sum(p.size for p in parts)
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin_memory)
        np.concatenate(parts, out=buf.numpy())
        out.append(buf)
    for x in (a_off, b_off, m, n):
        t = torch.from_numpy(x)
        out.append(t.pin_memory() if pin_memory else t)
    return tuple(out)


def check_packed(kernel: str, packed: tuple[torch.Tensor, ...]) -> int:
    """Raise unless the packed tensors are what the kernels take, on one
    card the sm_90a kernels run on; returns the number of tasks."""
    device = packed[4].device
    for t, dtype in zip(packed, PACKED_DTYPES):
        if t.device != device or device.type != "cuda":
            msg = f"{kernel} needs every tensor on one CUDA device, got {t.device}"
            raise ValueError(msg)
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            msg = f"{kernel} needs contiguous 1-D {dtype}, got {t.dtype} {tuple(t.shape)}"
            raise ValueError(msg)
    a_off, b_off, m, n = packed[2:]
    nb = m.numel()
    if not (n.numel() == a_off.numel() == b_off.numel() == nb):
        msg = f"{kernel}: m, n and the offsets differ in length"
        raise ValueError(msg)
    backend.check_capability(device, kernel)
    return nb
