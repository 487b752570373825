"""Batched Smith-Waterman for ANIb: the CUDA kernel and its plain version.

Port of ``pyani_plus_tpu/ops/sw_pallas.py`` and of the contract of
``pyani_plus_tpu/ops/dp_jax.py``'s ``batch_local_align_best``: per
(fragment, window) task, the best affine-gap local alignment score under
blastn scoring and its cell ``(score, best_i, best_j)``, exact to the
integer. The cell is 1-based and the first maximum in row-major order
(the host stats DP's rule), ``(0, 0)`` when no cell scores above 0. A
code >= 4 never matches: N == N, IUPAC letters and the padding code 5.

- ``sw_cuda`` launches ``csrc/sw.cu`` on packed tensors (one warp per
  task, tasks of any length: no shape ladder, no window limit;
  ``ops/_tasks.pack_tasks`` packs them in the caller's order). Inside
  the one launch a task whose scores fit 16 bits runs two columns a
  register (``uses_packed_lanes``); any other runs in 32-bit words.
- ``batch_sw_best_reference`` is the plain PyTorch version: row by row
  over (tasks, columns) tensors, the E state by ``torch.cummax``, on CPU
  tensors.
- ``batch_sw_best_host`` is the native oracle: the host score kernel and
  the host stats DP's winning cell.
- ``batch_sw_best`` sends a CUDA device to the kernel and the CPU to the
  plain version. Nothing falls back from one to the other. Given a list
  of devices it splits the tasks over them (``batch_sw_best_submit`` /
  ``batch_sw_best_collect``), the counterpart of ``dp_jax``'s
  ``_dispatch_sharded``: one contiguous slice a device, in order, each
  CUDA slice sent through ``ops/_tasks.submit`` on its own device's
  current stream.

The scoring constants are the host DP's (``ops/dp.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from pyani_plus_tpu_torch.ops._build import load_library
from pyani_plus_tpu_torch.ops._tasks import Submitted, Task, check_packed, submit
from pyani_plus_tpu_torch.ops.dp import GAP_EXTEND, GAP_OPEN, NEG, PENALTY, REWARD

__all__ = [
    "batch_sw_best",
    "batch_sw_best_collect",
    "batch_sw_best_host",
    "batch_sw_best_reference",
    "batch_sw_best_submit",
    "reset_counts",
    "sw_cuda",
    "uses_packed_lanes",
]

PAD_CODE = 5  # the JAX kernels' padding code; never matches anything

Result = tuple[int, int, int]

# csrc/sw.cu's geometry: window columns a lane owns in one stripe, on the
# packed 16-bit path (two a register) and on the 32-bit path.
PACKED_COLS = 24
WIDE_COLS = 8
INT16_MAX = 32767


def uses_packed_lanes(m: int, n: int) -> bool:
    """Whether the kernel runs an (m, n) task in packed 16-bit lanes.

    The kernel computes the same rule from the same numbers. The largest
    value a packed word holds is a cell's score plus the E scan's column
    offset within one lane: no local alignment scores above
    ``REWARD * min(m, n)``, and the offset is at most
    ``GAP_EXTEND * (PACKED_COLS - 1)``. The window's length alone never
    matters: the scan across lanes and stripes runs in 32-bit words, and
    what it hands a lane is clamped at 0, below which it cannot lift a
    cell. With blastn's 2 and 2 the rule is ``min(m, n) <= 16360``.
    """
    return REWARD * min(m, n) + GAP_EXTEND * (PACKED_COLS - 1) <= INT16_MAX


# Kernel launches and tasks sent through them, counted where the kernel
# is launched and nowhere else (plain integers; reset_counts() zeroes).
LAUNCHES = 0
TASKS = 0
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global LAUNCHES, TASKS
    with _COUNT_LOCK:
        LAUNCHES = 0
        TASKS = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("sw")
    if lib.sw_launch.argtypes is None:
        lib.sw_launch.restype = ctypes.c_int
        lib.sw_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        )
        lib.sw_error_string.restype = ctypes.c_char_p
        lib.sw_error_string.argtypes = [ctypes.c_int]
    return lib


def sw_cuda(
    q_all: torch.Tensor,
    s_all: torch.Tensor,
    q_off: torch.Tensor,
    s_off: torch.Tensor,
    m: torch.Tensor,
    n: torch.Tensor,
) -> torch.Tensor:
    """Launch the kernel on packed tensors that lie on the card.

    Returns the (B, 3) int32 ``(score, best_i, best_j)`` rows on the card
    without synchronising; launches on the current stream. Raises on
    anything the kernel does not take, and when the launch is refused.
    """
    global LAUNCHES, TASKS
    nb = check_packed("sw_cuda", (q_all, s_all, q_off, s_off, m, n))
    device = m.device
    out = torch.empty((nb, 3), dtype=torch.int32, device=device)
    if nb == 0:
        return out
    # the stripe boundary (H, E carry) of every fragment row, 32-bit words
    scratch = torch.empty((q_all.numel(), 2), dtype=torch.int32, device=device)
    lib = _kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sw_launch(
            q_all.data_ptr(), s_all.data_ptr(), q_off.data_ptr(), s_off.data_ptr(),
            m.data_ptr(), n.data_ptr(), nb, scratch.data_ptr(), out.data_ptr(), stream,
        )  # fmt: skip
    if rc != 0:
        msg = f"Smith-Waterman kernel launch failed: {lib.sw_error_string(rc).decode()}"
        raise RuntimeError(msg)
    with _COUNT_LOCK:
        LAUNCHES += 1
        TASKS += nb
    return out


# The plain version pads a chunk of tasks to its longest fragment and
# window; chunks hold tasks of similar window length (sorted, at most a
# factor 2 apart) so that padding stays small.
_CHUNK_TASKS = 256


def batch_sw_best_reference(tasks: list[Task]) -> list[Result]:
    """Plain PyTorch version of the kernel, on CPU tensors."""
    results: list[Result] = [(0, 0, 0)] * len(tasks)
    live = [t for t, (q, s) in enumerate(tasks) if q.size and s.size]
    live.sort(key=lambda t: (tasks[t][1].size, tasks[t][0].size))
    chunks: list[list[int]] = []
    for t in live:
        if (
            not chunks
            or len(chunks[-1]) == _CHUNK_TASKS
            or tasks[t][1].size > 2 * max(64, tasks[chunks[-1][0]][1].size)
        ):
            chunks.append([])
        chunks[-1].append(t)
    with torch.inference_mode():
        for chunk in chunks:
            rows = _reference_rows([tasks[t] for t in chunk])
            for t, row in zip(chunk, rows):
                results[t] = row
    return results


def _reference_rows(tasks: list[Task]) -> list[Result]:
    """dp_jax's row recurrence over one padded chunk (rows past a task's
    fragment and columns past its window are padding, which never
    matches and so never reaches the best score)."""
    nb = len(tasks)
    m_max = max(q.size for q, _ in tasks)
    n_max = max(s.size for _, s in tasks)
    q = np.full((nb, m_max), PAD_CODE, np.int32)
    s = np.full((nb, n_max), PAD_CODE, np.int32)
    for t, (qt, st) in enumerate(tasks):
        q[t, : qt.size] = qt
        s[t, : st.size] = st
    # codes >= 4 never match: -2 and -1 differ from each other and 0..3
    q_key = torch.from_numpy(np.where(q < 4, q, -2))
    s_key = torch.from_numpy(np.where(s < 4, s, -1))
    i32 = torch.int32
    reward = torch.tensor(REWARD, dtype=i32)
    penalty = torch.tensor(PENALTY, dtype=i32)
    ge = GAP_EXTEND
    ge_j = ge * torch.arange(1, n_max + 1, dtype=i32)
    h = torch.zeros((nb, n_max), dtype=i32)
    f = torch.full((nb, n_max), int(NEG), dtype=i32)
    diag = torch.zeros((nb, n_max), dtype=i32)  # column 0 of H stays 0
    e_in = torch.full((nb, n_max), int(NEG), dtype=i32)  # E fill at j == 1
    best = torch.zeros(nb, dtype=i32)
    best_i = torch.zeros(nb, dtype=i32)
    best_j = torch.zeros(nb, dtype=i32)
    for i in range(1, m_max + 1):
        sub = torch.where(s_key == q_key[:, i - 1 : i], reward, penalty)
        diag[:, 1:] = h[:, :-1]
        f = torch.maximum(h - (GAP_OPEN + ge), f - ge)
        g = torch.maximum(diag + sub, f).clamp_min_(0)
        e_in[:, 1:] = torch.cummax(g + ge_j, dim=1).values[:, :-1]
        h = torch.maximum(g, e_in - GAP_OPEN - ge_j)
        row_j = torch.argmax(h, dim=1)  # the first maximum of the row
        row_best = h.gather(1, row_j[:, None])[:, 0]
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        best_i = torch.where(improved, i, best_i)
        best_j = torch.where(improved, row_j.to(i32) + 1, best_j)
    return list(zip(best.tolist(), best_i.tolist(), best_j.tolist()))


def batch_sw_best_host(tasks: list[Task], *, workers: int = 1) -> list[Result]:
    """The native oracle, task by task: the host score kernel and the
    host stats DP's winning cell (its query_end and subject_end). The
    kernels release the GIL, so `workers` threads run tasks at once."""
    from concurrent.futures import ThreadPoolExecutor

    from pyani_plus_tpu_torch.native import (
        local_align_score_native,
        local_align_stats_native,
    )

    scoring = (REWARD, PENALTY, GAP_OPEN, GAP_EXTEND)

    def one(task: Task) -> Result:
        score = local_align_score_native(*task, *scoring)
        stats = local_align_stats_native(*task, *scoring)
        if score is None or stats is None:
            raise RuntimeError("the native align kernel did not build (g++ needed)")
        if stats is False:  # no cell scores above 0
            return score, 0, 0
        return score, stats[7], stats[9]

    if workers <= 1 or len(tasks) <= 1:
        return [one(task) for task in tasks]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(one, tasks))


def slice_bounds(count: int, parts: int) -> list[tuple[int, int]]:
    """``parts`` contiguous slices of ``count`` tasks, in order, their
    lengths at most one apart."""
    edges = [count * i // parts for i in range(parts + 1)]
    return list(zip(edges[:-1], edges[1:]))


def batch_sw_best_submit(tasks: list[Task], devices: list) -> list[Submitted]:
    """Start the tasks split over ``devices``: one contiguous slice a
    device, in order. A CUDA slice goes through ``ops/_tasks.submit`` on
    that device's current stream (packed, copied, launched and its
    results queued back with an event, without waiting); a CPU slice
    runs the plain version here.

    The JAX package pads the batch to a multiple of the device count with
    ``PAD_CODE`` rows, since a sharded array needs equal shards. Tasks
    are independent and a launch takes any count, so slices need no
    padding: their lengths differ by at most one.
    """
    devices = [torch.device(d) for d in devices]
    parts: list[Submitted] = []
    for device, (lo, hi) in zip(devices, slice_bounds(len(tasks), len(devices))):
        chunk = tasks[lo:hi]
        if device.type == "cpu" or not chunk:
            parts.append(Submitted(batch_sw_best_reference(chunk)))
            continue
        if device.type != "cuda":
            msg = f"no Smith-Waterman path for device {device}"
            raise ValueError(msg)
        with torch.cuda.device(device):
            parts.append(submit(sw_cuda, chunk, device, 3))
    return parts


def batch_sw_best_collect(parts: list[Submitted]) -> list[Result]:
    """Wait for each part of a submitted batch (its own event, nothing
    device-wide) and return the results in task order."""
    return [row for part in parts for row in part.rows()]


def batch_sw_best(tasks: list[Task], device: torch.device | str | list) -> list[Result]:
    """The kernel for a CUDA device, the plain version for the CPU; a
    list of devices splits the tasks over them."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    return batch_sw_best_collect(batch_sw_best_submit(tasks, devices))
