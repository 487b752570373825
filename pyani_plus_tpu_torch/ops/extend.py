"""Batched free-end extensions: the CUDA kernel and its plain version.

Port of ``pyani_plus_tpu/ops/extend_pallas.py``. Same result contract as
``batch_extend_pallas`` and as the host oracle
``native.band_dp_native(a, b, 60, True, MATCH, MISMATCH, OPEN, EXTEND,
stop_rows)``: per task ``(a_advance, b_advance, errors, nonid,
gap_columns)`` of the best free-end extension from the origin, exact to
the integer.

- ``batch_extend_submit`` / ``batch_extend_collect`` run a list of
  ragged (a, b) code tails through ``csrc/extend.cu`` (one warp per
  task, any length: no padding ladder and no host route for long
  tasks). Submit packs the tasks, longest first, into one page-locked
  staging buffer, copies it to the card in one transfer, launches the
  kernel and queues the copy of the results back, all on the calling
  thread's own stream and without waiting; collect waits for that
  batch's event only. Pair threads therefore overlap their launches on
  the card, and a caller can do host work between the two.
- ``batch_extend_reference`` is the plain PyTorch version: (B, 128)
  int64 band states advanced one row at a time for all tasks together,
  with the I state closed by ``torch.cummax`` and a gather. It always
  runs on CPU tensors, whose ``cummax`` returns the latest index on ties
  (the host's ``key >= run_max``).
- ``batch_extend`` sends a CUDA device to the kernel and the CPU to the
  plain version. Nothing falls back from one to the other.

The scoring constants are the host oracle's (``ops/extend_host.py``).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from pyani_plus_tpu_torch.ops._build import load_library
from pyani_plus_tpu_torch.ops._tasks import Task, check_packed
from pyani_plus_tpu_torch.ops.extend_host import EXTEND, MATCH, MISMATCH, NEG, OPEN
from pyani_plus_tpu_torch.utils import devmeter

BAND = 60  # csrc/extend.cu is laid out for this band: 4 columns x 32 lanes
WIDTH = 2 * BAND + 1  # 121 live band columns
LANE = 128  # band columns padded to one warp's 32 lanes x 4
STOP_ROWS = 600  # give-up rule: 3 * anim.EXT_BREAKLEN
# The kernel packs errors, nonid and gap columns (each <= m + n) into
# 16-bit fields for a task with m + n up to this, and keeps 32-bit
# fields for a longer one (csrc/extend.cu PACK_LIMIT).
PACK_LIMIT = 65535

Result = tuple[int, int, int, int, int]

# Kernel launches and tasks sent through them, counted where the kernel
# is launched and nowhere else (plain integers; reset_counts() zeroes).
LAUNCHES = 0
TASKS = 0
_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()  # .streams: device index -> this thread's stream
# Packing is a millisecond of Python and numpy under the GIL. Pair threads
# that pack at the same moment hand the GIL back and forth in 5 ms
# slices and each takes ten times as long; with this lock they take
# turns, and the waiting ones leave the GIL alone.
_PACK_LOCK = threading.Lock()


def reset_counts() -> None:
    global LAUNCHES, TASKS
    with _COUNT_LOCK:
        LAUNCHES = 0
        TASKS = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("extend")
    if lib.extend_launch.argtypes is None:
        lib.extend_launch.restype = ctypes.c_int
        lib.extend_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
        )
        lib.extend_error_string.restype = ctypes.c_char_p
        lib.extend_error_string.argtypes = [ctypes.c_int]
    return lib


def launch_order(tasks: list[Task]) -> np.ndarray:
    """Task indices in launch order: longest ``a`` (most rows) first, so
    that the long serial chains start at once and the short tasks fill
    in behind them; ties keep the caller's order."""
    rows = np.array([a.size for a, _ in tasks], dtype=np.int64)
    return np.argsort(-rows, kind="stable")


def uses_packed_fields(task: Task) -> bool:
    """Whether the kernel runs this task with 16-bit payload fields."""
    return task[0].size + task[1].size <= PACK_LIMIT


def pack_tasks(
    tasks: list[Task], *, pin_memory: bool = False
) -> tuple[torch.Tensor, np.ndarray]:
    """Ragged tasks as ONE uint8 staging buffer in launch order, and that
    order (``order[p]`` is the caller's index of the task at position
    ``p``). The buffer holds, for B tasks: B int64 offsets of the ``a``
    codes and B of the ``b`` codes (into the code bytes), B int32 ``m``
    and B int32 ``n``, then every task's ``a`` codes and every task's
    ``b`` codes back to back. ``split_packed`` gives the six views.

    ``pin_memory`` packs into page-locked memory, so that one copy to the
    card with ``non_blocking=True`` neither waits for the stream nor
    blocks the host.
    """
    order = launch_order(tasks)
    nb = len(tasks)
    m = np.array([tasks[t][0].size for t in order], dtype=np.int32)
    n = np.array([tasks[t][1].size for t in order], dtype=np.int32)
    a_bytes = int(m.sum(dtype=np.int64))
    b_bytes = int(n.sum(dtype=np.int64))
    a_off = np.zeros(nb, dtype=np.int64)
    b_off = np.full(nb, a_bytes, dtype=np.int64)
    a_off[1:] = np.cumsum(m[:-1], dtype=np.int64)
    b_off[1:] += np.cumsum(n[:-1], dtype=np.int64)
    head = 24 * nb
    # a spare byte keeps the code section non-empty when every task is empty
    buf = torch.empty(head + a_bytes + b_bytes + 1, dtype=torch.uint8, pin_memory=pin_memory)
    raw = buf.numpy()
    raw[: 8 * nb].view(np.int64)[:] = a_off
    raw[8 * nb : 16 * nb].view(np.int64)[:] = b_off
    raw[16 * nb : 20 * nb].view(np.int32)[:] = m
    raw[20 * nb : head].view(np.int32)[:] = n
    codes = [np.asarray(tasks[t][0], np.uint8) for t in order]
    codes += [np.asarray(tasks[t][1], np.uint8) for t in order]
    codes.append(np.zeros(1, np.uint8))
    np.concatenate(codes, out=raw[head:])
    return buf, order


def split_packed(buf: torch.Tensor, nb: int) -> tuple[torch.Tensor, ...]:
    """The six views of a staging buffer (on any device) that the kernel
    takes: (a_all, b_all) uint8 code bytes (the same bytes: the offsets
    tell them apart), (a_off, b_off) int64 and (m, n) int32."""
    codes = buf[24 * nb :]
    return (
        codes,
        codes,
        buf[: 8 * nb].view(torch.int64),
        buf[8 * nb : 16 * nb].view(torch.int64),
        buf[16 * nb : 20 * nb].view(torch.int32),
        buf[20 * nb : 24 * nb].view(torch.int32),
    )


def extend_cuda(
    a_all: torch.Tensor,
    b_all: torch.Tensor,
    a_off: torch.Tensor,
    b_off: torch.Tensor,
    m: torch.Tensor,
    n: torch.Tensor,
    *,
    stop_rows: int = STOP_ROWS,
) -> torch.Tensor:
    """Launch the kernel on packed tensors that lie on the card.

    Returns the (B, 5) int32 result on the card without synchronising;
    launches on the current stream. Raises on anything the kernel does
    not take, and when the launch is refused.
    """
    global LAUNCHES, TASKS
    nb = check_packed("extend_cuda", (a_all, b_all, a_off, b_off, m, n))
    device = m.device
    out = torch.empty((nb, 5), dtype=torch.int32, device=device)
    if nb == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.extend_launch(
            a_all.data_ptr(), b_all.data_ptr(), a_off.data_ptr(), b_off.data_ptr(),
            m.data_ptr(), n.data_ptr(), nb, stop_rows,
            MATCH, MISMATCH, OPEN, EXTEND, out.data_ptr(), stream,
        )  # fmt: skip
    if rc != 0:
        msg = f"extension kernel launch failed: {lib.extend_error_string(rc).decode()}"
        raise RuntimeError(msg)
    with _COUNT_LOCK:
        LAUNCHES += 1
        TASKS += nb
    return out


@dataclass
class Submitted:
    """A batch on its way: what ``batch_extend_collect`` waits for."""

    out: torch.Tensor | list[Result]  # pinned (B, 5) int32, or CPU results
    order: np.ndarray | None  # launch position -> caller's index
    arrived: torch.cuda.Event | None
    t_submit: float
    keep: tuple = ()  # tensors the queued work still reads


def _thread_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's own stream on ``device`` (made at first use), so that
    batches of different pair threads run side by side on the card."""
    streams = _THREAD.__dict__.setdefault("streams", {})
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in streams:
        streams[index] = torch.cuda.Stream(device=index)
    return streams[index]


def batch_extend_submit(
    tasks: list[Task],
    device: torch.device | str,
    *,
    stop_rows: int = STOP_ROWS,
) -> Submitted:
    """Start a batch of extensions: the kernel for a CUDA device (queued,
    not awaited), the plain version for the CPU (computed here)."""
    device = torch.device(device)
    t_submit = devmeter.now()
    if device.type == "cpu":
        results = batch_extend_reference(tasks, stop_rows=stop_rows)
        return Submitted(results, None, None, t_submit)
    if device.type != "cuda":
        msg = f"no extension path for device {device}"
        raise ValueError(msg)
    if not tasks:
        return Submitted([], None, None, t_submit)
    with _PACK_LOCK:
        staging, order = pack_tasks(tasks, pin_memory=True)
        out = torch.empty((len(tasks), 5), dtype=torch.int32, pin_memory=True)
    stream = _thread_stream(device)
    with torch.cuda.stream(stream):
        on_card = staging.to(device, non_blocking=True)
        result = extend_cuda(*split_packed(on_card, len(tasks)), stop_rows=stop_rows)
        out.copy_(result, non_blocking=True)
        arrived = torch.cuda.Event()
        arrived.record(stream)
    return Submitted(out, order, arrived, t_submit, keep=(staging, on_card, result))


def batch_extend_collect(state: Submitted) -> list[Result]:
    """Wait for a submitted batch (its own event, nothing device-wide)
    and return the results in the caller's task order."""
    if state.arrived is None:
        return state.out  # type: ignore[return-value]
    state.arrived.synchronize()
    devmeter.record(state.t_submit)
    rows = np.empty((len(state.order), 5), dtype=np.int32)
    rows[state.order] = state.out.numpy()
    state.keep = ()
    return [tuple(row) for row in rows.tolist()]


def batch_extend_cuda(
    tasks: list[Task],
    *,
    stop_rows: int = STOP_ROWS,
    device: torch.device | str = "cuda",
) -> list[Result]:
    """The kernel over a list of (a, b) code tails; one launch, awaited."""
    device = torch.device(device)
    if device.type != "cuda":
        msg = f"batch_extend_cuda needs a CUDA device, got {device}"
        raise ValueError(msg)
    return batch_extend_collect(batch_extend_submit(tasks, device, stop_rows=stop_rows))


def _pick(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Max of two stacked (score, e, n, g) states; the first wins ties."""
    return torch.where(y[0] > x[0], y, x)


def batch_extend_reference(
    tasks: list[Task], *, stop_rows: int = STOP_ROWS
) -> list[Result]:
    """Plain PyTorch version of the kernel, on CPU tensors.

    Mirrors the host oracle's recurrences and tie rules (extend_host.py
    ``_band_dp`` with ``free_end=True``) for all tasks at once, with
    per-task row limits and give-up masks. Each state is one (4, B, 128)
    int64 tensor of (score, errors, nonid, gap columns).
    """
    nb = len(tasks)
    if nb == 0:
        return []
    with torch.inference_mode():
        return _reference_rows(tasks, stop_rows)


def _reference_rows(tasks: list[Task], stop_rows: int) -> list[Result]:  # noqa: PLR0915
    nb = len(tasks)
    m = torch.tensor([a.size for a, _ in tasks], dtype=torch.int64)
    n = torch.tensor([b.size for _, b in tasks], dtype=torch.int64)
    m_max = int(m.max())
    n_max = int(n.max())
    # a_pad[:, i - 1] = a[i - 1]; column k of row i reads b[k + i - BAND - 1]
    # = b_ext[:, i + k], so b sits at offset BAND + 1 of b_ext.
    a_pad = torch.full((nb, max(1, m_max)), 255, dtype=torch.int64)
    b_ext = torch.full(
        (nb, max(m_max + LANE, BAND + 1 + n_max)), 255, dtype=torch.int64
    )
    for t, (a, b) in enumerate(tasks):
        a_pad[t, : a.size] = torch.from_numpy(np.asarray(a, dtype=np.int64))
        b_ext[t, BAND + 1 : BAND + 1 + b.size] = torch.from_numpy(
            np.asarray(b, dtype=np.int64)
        )
    offs = torch.arange(LANE, dtype=torch.int64)
    col_ok = offs < WIDTH
    half_neg = NEG // 2
    dead_state = torch.tensor([NEG, 0, 0, 0], dtype=torch.int64).view(4, 1, 1)
    # substitution (score, errors, nonid, gaps) deltas, indexed by
    # [letters equal] + [A/C/G/T match]
    sub_delta = torch.tensor(
        [[MISMATCH, 1, 1, 0], [MISMATCH, 1, 0, 0], [MATCH, 0, 0, 0]],
        dtype=torch.int64,
    )
    i_key_offset = OPEN - EXTEND * (offs + 1)
    i_score_offset = EXTEND * offs

    # Per-task tensors, dim 0 over the tasks still running; finished
    # tasks are dropped (their best cell saved) once they are half.
    task = {
        "idx": torch.arange(nb),
        "m": m,
        "n": n[:, None],
        "a": a_pad,
        "a_acgt": a_pad < 4,  # a code >= 4 (N, IUPAC, padding) never matches
        "b": b_ext,
        "b_acgt": b_ext < 4,
        "best": torch.zeros((nb, 6), dtype=torch.int64),  # i j s e n g
        "rows_since": torch.zeros(nb, dtype=torch.int64),
        "dead": torch.zeros(nb, dtype=torch.bool),
        # Shift buffers: up[:, :, k] holds column k + 1 of the previous
        # row (max(M, I), then D), left_* the I scan shifted by one
        # column; their edge columns stay dead.
        "up": dead_state.repeat(2, nb, LANE).permute(1, 0, 2),
        "left_max": torch.full((nb, LANE), NEG, dtype=torch.int64),
        "left_src": torch.zeros((nb, LANE), dtype=torch.int64),
    }
    final = torch.zeros((nb, 6), dtype=torch.int64)

    # Row 0: the origin in M at j == 0; I holds the horizontal runs.
    js0 = offs - BAND
    M = dead_state.repeat(1, nb, LANE)
    M[0] = torch.where(col_ok & (js0 == 0), 0, NEG)
    D = dead_state.repeat(1, nb, LANE)
    i_ok = col_ok & (js0 >= 1) & (js0 <= task["n"])
    I = torch.stack([
        torch.where(i_ok, OPEN + EXTEND * (js0 - 1), NEG),
        *[torch.where(i_ok, js0, 0)] * 3,
    ])  # fmt: skip

    def update_best(i: int, cell: torch.Tensor, active: torch.Tensor):
        """The host's per-row rule: the row max, its largest column, and an
        update on a greater score or an equal score with larger i + j."""
        best = task["best"]
        cs = cell[0]
        rmax = cs.max(dim=1).values
        kmax = torch.where(cs == rmax[:, None], offs, -1).max(dim=1).values
        jb = kmax + (i - BAND)
        upd = active & (
            (rmax > best[:, 2])
            | ((rmax == best[:, 2]) & (i + jb > best[:, 0] + best[:, 1]))
        )
        picked = cell[1:].gather(2, kmax.view(1, -1, 1).expand(3, -1, 1))[:, :, 0]
        new = torch.stack([torch.full_like(jb, i), jb, rmax, *picked], dim=1)
        best.copy_(torch.where(upd[:, None], new, best))
        return upd

    update_best(0, _pick(_pick(M, D), I), torch.ones(nb, dtype=torch.bool))

    for i in range(1, m_max + 1):
        active = (task["m"] >= i) & ~task["dead"]
        n_active = int(active.sum())
        if n_active == 0:
            break
        if n_active <= active.numel() // 2:
            final[task["idx"][~active]] = task["best"][~active]
            keep = active.nonzero()[:, 0]
            task = {key: val[keep] for key, val in task.items()}
            M, D, I = M[:, keep], D[:, keep], I[:, keep]
            active = active[keep]
        up = task["up"].permute(1, 0, 2)
        left_max, left_src = task["left_max"], task["left_src"]
        # band column k holds j = k + i - BAND
        valid = (col_ok & (offs >= BAND - i)) & (offs <= task["n"] + (BAND - i))
        valid1 = valid & (offs >= BAND + 1 - i)  # j >= 1
        ac = task["a"][:, i - 1 : i]
        bc = task["b"][:, i : i + LANE]

        # --- M: diagonal predecessor (same column), best3 M >= D >= I
        p = _pick(_pick(M, D), I)
        same = bc == ac
        sub_ok = same & task["a_acgt"][:, i - 1 : i] & task["b_acgt"][:, i : i + LANE]
        delta = sub_delta[same.long() + sub_ok.long()].permute(2, 0, 1)
        live_m = valid1 & (p[0] > half_neg)
        nM = torch.where(live_m, p + delta, dead_state)

        # --- D: vertical predecessor is column k+1 of the previous row;
        # open from max(M, I) (tie M), continue from D on ties
        up[:4, :, :-1] = _pick(M, I)[:, :, 1:]
        up[4:, :, :-1] = D[:, :, 1:]
        open_s = torch.where(up[0] > half_neg, up[0] + OPEN, NEG)
        cont_s = torch.where(up[4] > half_neg, up[4] + EXTEND, NEG)
        take_cont = cont_s >= open_s
        d = torch.where(take_cont, up[4:], up[:4])
        d[0] = torch.where(take_cont, cont_s, open_s)
        d[1:] += 1
        nD = torch.where(~valid | (d[0] <= half_neg), dead_state, d)

        # --- I: latest running-max source of the row's open keys
        base = _pick(nM, nD)
        key = torch.where(base[0] > half_neg, base[0] + i_key_offset, NEG)
        run_max, src = torch.cummax(key, dim=1)
        left_max[:, 1:] = run_max[:, :-1]
        left_src[:, 1:] = src[:, :-1]
        ok_i = valid1 & (left_max > half_neg)
        pay = base[1:].gather(2, left_src.expand(3, -1, -1)) + (offs - left_src)
        nI = torch.where(
            ok_i, torch.cat([(left_max + i_score_offset)[None], pay]), dead_state
        )

        M, D, I = nM, nD, nI
        upd = update_best(i, _pick(_pick(M, D), I), active)
        rows_since = task["rows_since"]
        rows_since.copy_(
            torch.where(active, torch.where(upd, 0, rows_since + 1), rows_since)
        )
        if stop_rows > 0:
            task["dead"] |= active & (rows_since >= stop_rows)

    final[task["idx"]] = task["best"]
    return [(i, j, e, n_, g) for i, j, _s, e, n_, g in final.tolist()]


def batch_extend_host(
    tasks: list[Task], *, stop_rows: int = STOP_ROWS, workers: int = 1
) -> list[Result]:
    """The native host kernel, task by task: the CPU production path and
    the oracle both versions above are held to. The kernel releases the
    GIL, so `workers` threads run tasks at once."""
    from concurrent.futures import ThreadPoolExecutor

    from pyani_plus_tpu_torch.native import band_dp_native

    def one(task: Task) -> Result:
        res = band_dp_native(
            *task, BAND, True, MATCH, MISMATCH, OPEN, EXTEND, stop_rows
        )
        if res is None:
            raise RuntimeError("the native band kernel did not build (g++ needed)")
        i, j, _score, err, nid, gap = res
        return i, j, err, nid, gap

    if workers <= 1 or len(tasks) <= 1:
        return [one(task) for task in tasks]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(one, tasks))


def batch_extend(
    tasks: list[Task],
    device: torch.device | str,
    *,
    stop_rows: int = STOP_ROWS,
) -> list[Result]:
    """The kernel for a CUDA device, the plain version for the CPU."""
    return batch_extend_collect(batch_extend_submit(tasks, device, stop_rows=stop_rows))
