"""Ragged (a, b) code tasks as one flat buffer, the layout both kernels take,
and the one way a batch goes to the card and its results come back.

A batch of tasks becomes one uint8 buffer: int64 start offsets of every
task's ``a`` and ``b`` codes, int32 lengths, then the codes back to back.
No padding, so tasks of any length share one launch, and one copy moves
the whole batch. ``submit`` packs, copies, launches and queues the results
back without waiting; ``Submitted.rows`` waits for that batch alone.
"""

from __future__ import annotations

import threading
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from pyani_plus_tpu_torch import backend

Task = tuple[np.ndarray, np.ndarray]

PACKED_DTYPES = (
    torch.uint8, torch.uint8, torch.int64, torch.int64, torch.int32, torch.int32
)
# Packing is a millisecond of Python and numpy under the GIL. Threads that
# pack at the same moment hand the GIL back and forth in 5 ms slices and
# each takes ten times as long; with this lock they take turns, and the
# waiting ones leave the GIL alone.
_PACK_LOCK = threading.Lock()


@dataclass(frozen=True)
class Packed:
    """A packed batch: the buffer, its task count and its ``a`` code bytes.

    For B tasks the buffer holds B int64 offsets of the ``a`` codes and B
    of the ``b`` codes (into the code section), B int32 ``m`` and B int32
    ``n``, then every task's ``a`` codes, every task's ``b`` codes and one
    spare byte, which keeps the code section non-empty when every task is
    empty.
    """

    buf: torch.Tensor
    count: int
    a_bytes: int

    def views(self, buf: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
        """The six tensors the kernels take, as views of ``buf`` (this
        buffer, or its copy on a device): ``a_all`` (the ``a`` codes and
        the byte after them, so that its size counts the ``a`` rows) and
        ``b_all`` (the whole code section: the offsets tell the two
        apart), ``a_off``, ``b_off``, ``m`` and ``n``."""
        buf = self.buf if buf is None else buf
        nb = self.count
        codes = buf[24 * nb :]
        return (
            codes[: self.a_bytes + 1],
            codes,
            buf[: 8 * nb].view(torch.int64),
            buf[8 * nb : 16 * nb].view(torch.int64),
            buf[16 * nb : 20 * nb].view(torch.int32),
            buf[20 * nb : 24 * nb].view(torch.int32),
        )


def pack_tasks(
    tasks: list[Task], order: np.ndarray | None = None, *, pin_memory: bool = False
) -> Packed:
    """Ragged tasks as ONE uint8 buffer, in ``order`` when given (the task
    at position ``p`` is ``tasks[order[p]]``), else in the caller's order.

    ``pin_memory`` packs into page-locked memory, so that one copy to the
    card with ``non_blocking=True`` neither waits for the stream nor
    blocks the host.
    """
    if order is not None:
        tasks = [tasks[t] for t in order]
    nb = len(tasks)
    m = np.array([a.size for a, _ in tasks], dtype=np.int32)
    n = np.array([b.size for _, b in tasks], dtype=np.int32)
    a_bytes = int(m.sum(dtype=np.int64))
    b_bytes = int(n.sum(dtype=np.int64))
    a_off = np.zeros(nb, dtype=np.int64)
    b_off = np.full(nb, a_bytes, dtype=np.int64)
    a_off[1:] = np.cumsum(m[:-1], dtype=np.int64)
    b_off[1:] += np.cumsum(n[:-1], dtype=np.int64)
    head = 24 * nb
    buf = torch.empty(head + a_bytes + b_bytes + 1, dtype=torch.uint8, pin_memory=pin_memory)
    raw = buf.numpy()
    raw[: 8 * nb].view(np.int64)[:] = a_off
    raw[8 * nb : 16 * nb].view(np.int64)[:] = b_off
    raw[16 * nb : 20 * nb].view(np.int32)[:] = m
    raw[20 * nb : head].view(np.int32)[:] = n
    codes = [np.asarray(a, np.uint8) for a, _ in tasks]
    codes += [np.asarray(b, np.uint8) for _, b in tasks]
    codes.append(np.zeros(1, np.uint8))
    np.concatenate(codes, out=raw[head:])
    return Packed(buf, nb, a_bytes)


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


@dataclass
class Submitted:
    """A batch on its way: page-locked (B, k) int32 rows being copied back
    and the event that marks their arrival, or rows already computed."""

    out: torch.Tensor | list[tuple]
    order: np.ndarray | None = None  # launch position -> caller's index
    arrived: torch.cuda.Event | None = None
    keep: tuple = ()  # tensors the queued work still reads

    def wait(self) -> None:
        """Block until this batch's rows are on the host (its own event,
        nothing device-wide)."""
        if self.arrived is not None:
            self.arrived.synchronize()
            self.arrived = None

    def rows(self) -> list[tuple]:
        """The batch's rows in the caller's task order, once they are here."""
        self.wait()
        if isinstance(self.out, list):
            return self.out
        rows = self.out.numpy()
        if self.order is not None:
            rows = np.empty_like(rows)
            rows[self.order] = self.out.numpy()
        self.keep = ()
        return [tuple(row) for row in rows.tolist()]


def submit(
    launch: Callable[..., torch.Tensor],
    tasks: list[Task],
    device: torch.device,
    width: int,
    order: np.ndarray | None = None,
) -> Submitted:
    """Start ``launch`` on a batch, on ``device``'s current stream, without
    waiting: pack the tasks (in ``order``, when given) into page-locked
    memory, copy them over in one transfer, launch on the six views there
    (``launch`` returns the (B, ``width``) int32 rows on the card), queue
    the copy of the rows back into page-locked memory and record an event
    after it."""
    with _PACK_LOCK:
        packed = pack_tasks(tasks, order, pin_memory=True)
        out = torch.empty((len(tasks), width), dtype=torch.int32, pin_memory=True)
    stream = torch.cuda.current_stream(device)
    on_card = packed.buf.to(device, non_blocking=True)
    result = launch(*packed.views(on_card))
    out.copy_(result, non_blocking=True)
    arrived = torch.cuda.Event()
    arrived.record(stream)
    return Submitted(out, order, arrived, keep=(packed.buf, on_card, result))
