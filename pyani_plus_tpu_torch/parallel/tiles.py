"""Device-mesh pair-tile sharding: the N x N comparison grid on several devices.

Port of ``pyani_plus_tpu/parallel/tiles.py`` onto a list of torch
devices. The all-vs-all grid is tiled over a 2D ("q", "s") mesh -- query
genomes split along "q", subject genomes along "s" -- so each device
owns an (N/q x N/s) tile of the pair grid; the contraction (hash) axis
streams in full on every device. Where the JAX package lets XLA place
the pieces from shardings, here each device is handed its rows and
computes its tile, and the tiles are gathered on the host.

A :class:`Mesh` is a grid of devices of this process, not of a process
group: ``jax.devices()`` spans every process of a group, while each
process of a torch group owns one card (``backend.kernel_device``), so
:func:`default_pair_mesh` gives no mesh inside a group of several
processes. A device may stand in the grid more than once (the same card
twice, or the CPU several times), which tests and the smoke run use to
check the split on one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """A 2D grid of torch devices with named axes."""

    devices: np.ndarray  # (nq, ns) object array of torch.device
    axis_names: tuple[str, str] = ("q", "s")

    @property
    def shape(self) -> tuple[int, int]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    n_devices: int | None = None,
    *,
    axis_names: tuple[str, str] = ("q", "s"),
    devices: list | None = None,
) -> Mesh:
    """Build a 2D mesh over ``devices`` (default: this process's CUDA
    devices, or the CPU without one), q-major, as square as possible."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)] or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        msg = "a mesh needs at least one device"
        raise ValueError(msg)
    # Factor n into (nq, ns) as square as possible
    nq = int(np.floor(np.sqrt(n)))
    while n % nq:
        nq -= 1
    ns = n // nq
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(nq, ns), tuple(axis_names))


_DEFAULT_MESH_CACHE: dict[tuple, Mesh] = {}


def default_pair_mesh() -> Mesh | None:
    """The production pair-grid mesh: every CUDA device of this process
    when there are two or more, else None.

    A multi-card process automatically splits the pair-grid work (the
    sourmash containment Gram, ANIb's batched Smith-Waterman) over this
    mesh. Inside a process group of more than one process each process
    keeps to its own card, so there is no mesh. ``PYANI_TPU_MESH=0``
    forces single-device execution.
    """
    from pyani_plus_tpu_torch.parallel import distributed

    if os.environ.get("PYANI_TPU_MESH", "1") == "0":
        return None
    if distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        return None
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    mesh = _DEFAULT_MESH_CACHE.get(devices)
    if mesh is None:
        mesh = make_mesh(devices=list(devices))
        _DEFAULT_MESH_CACHE[devices] = mesh
    return mesh


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int) -> np.ndarray:
    """Zero-pad an axis up to a multiple (static-shape friendliness)."""
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return np.pad(array, pad)


def mesh_tiles(n: int, mesh: Mesh):
    """(device, rows, columns) of every mesh entry's tile of an n x n
    grid, q-major.

    The rows are laid out as the JAX package lays out a P("q") / P("s")
    sharding: n is padded to a multiple of lcm(nq, ns) and cut into equal
    shards. The ranges are clipped to n, so a range may be empty when the
    mesh has more devices than rows.
    """
    nq, ns = mesh.shape
    multiple = int(np.lcm(nq, ns))
    padded = -(-n // multiple) * multiple

    def cut(parts: int) -> list[tuple[int, int]]:
        step = padded // parts
        return [(min(i * step, n), min((i + 1) * step, n)) for i in range(parts)]

    for i, rows in enumerate(cut(nq)):
        for j, cols in enumerate(cut(ns)):
            yield mesh.devices[i, j], rows, cols


# Membership columns per block of sharded_intersection_counts
_COLUMNS = 4096


def sharded_intersection_counts(membership: np.ndarray, mesh: Mesh) -> np.ndarray:
    """All-pairs sketch-intersection counts on a device mesh.

    ``membership`` is the (N, U) {0,1} sketch membership matrix (int8).
    Device (i, j) takes the rows of its "q" shard and of its "s" shard
    and computes their (Nq x Ns) Gram tile -- no device holds the full
    matrix product. This is the sourmash Gram (``ops/minhash.gram``) on
    the matrix's entries, 4,096 columns at a time. Returns the (N, N)
    int64 counts.
    """
    from pyani_plus_tpu_torch.ops.minhash import block_indices, gram

    n = membership.shape[0]
    rows, ids = np.nonzero(membership)
    if rows.size == 0:
        return np.zeros((n, n), dtype=np.int64)
    return gram(block_indices(rows, ids, n, _COLUMNS), n, _COLUMNS, mesh)


def sharded_containment_step(mesh: Mesh):
    """Return a sharded step: membership blocks -> counts tile.

    The returned ``step(counts, q_block, s_block)`` adds the block's
    products to the running (N, N) float32 counts: device (i, j) updates
    its tile from its rows of ``q_block`` and ``s_block`` (streaming over
    hash blocks, as the multichip dry run drives the JAX step).
    """

    def step(counts, q_block, s_block) -> np.ndarray:
        counts = np.array(counts, dtype=np.float32)
        q_block = np.asarray(q_block)
        s_block = np.asarray(s_block)
        done = []
        for device, (r0, r1), (c0, c1) in mesh_tiles(counts.shape[0], mesh):
            if r0 == r1 or c0 == c1:
                continue
            tile = torch.from_numpy(counts[r0:r1, c0:c1]).to(device)
            q = torch.from_numpy(q_block[r0:r1]).to(device).float()
            s = torch.from_numpy(s_block[c0:c1]).to(device).float()
            done.append(((r0, r1, c0, c1), tile + q @ s.T))
        for (r0, r1, c0, c1), tile in done:
            counts[r0:r1, c0:c1] = tile.cpu().numpy()
        return counts

    return step


def merge_partial_matrices(blocks: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Merge per-device partial result matrices (the JAX package's psum).

    ``blocks`` is (n_devices, N, N): device d's zero-masked partial of the
    full result matrix (its owned pair tiles filled, the rest 0). Each
    partial is sent to the mesh's first device and summed there, in
    device order -- the on-device analogue of the reference's JSON-import
    merge loop (workflows/__init__.py:49-109).
    """
    blocks = np.asarray(blocks)
    if blocks.shape[0] != mesh.size:
        msg = f"{blocks.shape[0]} partials for a mesh of {mesh.size} devices"
        raise ValueError(msg)
    first = mesh.devices.flat[0]
    total = torch.from_numpy(np.array(blocks[0])).to(first)
    for part in blocks[1:]:
        total += torch.from_numpy(np.ascontiguousarray(part)).to(first)
    return total.cpu().numpy()


def owned_pairs(n: int, process_index: int, process_count: int) -> list[tuple[int, int]]:
    """Static block ownership of the pair grid for multi-host runs.

    Host h owns every (q, s) pair with (q * n + s) % process_count == h;
    content-addressed INSERT OR IGNORE merges make overlapping ownership
    harmless.
    """
    return [
        (q, s)
        for q in range(n)
        for s in range(n)
        if (q * n + s) % process_count == process_index
    ]
