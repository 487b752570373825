"""FracMinHash containment on the card: the membership Gram and the device sketch.

Port of ``pyani_plus_tpu/ops/minhash.py``. The ``Sketch`` type, the host
sketch (``sketch_genome``, native C++ with a numpy route when there is
no compiler), the host Gram (``intersection_matrix_host``, scipy) and the
constants are that module's host half, kept as it is there.

- ``intersection_matrix_device``: all-pairs ``|A n B|``. The union of
  hashes is cut into blocks of ``block`` ids; each block's {0,1}
  membership matrix (N x block) is scattered on the device and
  ``counts += M @ M.T`` accumulates. The product is a plain
  ``torch.matmul`` (the JAX package's runs on XLA outside any Pallas
  kernel). Counts are exact: the operands are float32, where 0 and 1
  are exact also under TF32, each block's product is an integer of at
  most ``block`` < 2^24, and the blocks add up in float64, exact below
  2^53. (bf16 or fp16 operands would not do: ``torch.matmul`` returns
  their own type, which rounds counts above 256 or 2048.)
  On a process with several cards the Gram is split over the pair-grid
  mesh (``mesh="auto"``: ``parallel/tiles.default_pair_mesh``), as the
  JAX package shards it: each device scatters the membership of its
  tile's rows from the same indices and accumulates its tile, and the
  tiles meet on the mesh's first device (``gram``; one device is a mesh
  of one). The counts are the unsplit Gram's, bit for bit, for any grid.
- ``containment_ani``: the sourmash method's (identity, coverage), with
  the JAX package's threshold for the device Gram.
- ``sketch_genomes_device``: the host sketch's hashes, computed on the
  device: validity, canonical choice, ``murmur64_words`` and the
  ``max_hash`` filter, with every survivor brought back (no transfer cap
  and no host route for a full chunk).

Both run on the card or raise; with the CPU requested
(``PYANI_TPU_TORCH_DEVICE=cpu``) they run the same PyTorch code on the
CPU, as the JAX package runs its XLA code on the CPU. Nothing falls back
from one to the other.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from pyani_plus_tpu_torch import backend
from pyani_plus_tpu_torch.genomes import Genome
from pyani_plus_tpu_torch.ops.kmers import canonical_kmer_hashes
from pyani_plus_tpu_torch.ops.murmur3 import murmur64_words, signed64, to_uint64
from pyani_plus_tpu_torch.utils import spans

__all__ = [
    "DEFAULT_KMER",
    "DEFAULT_SCALED",
    "Sketch",
    "block_indices",
    "containment_ani",
    "gram",
    "intersection_matrix_device",
    "intersection_matrix_host",
    "max_hash_for_scaled",
    "reset_counts",
    "sketch_genome",
    "sketch_genome_device",
    "sketch_genomes_device",
]

DEFAULT_KMER = 31  # ref methods/sourmash.py:31
DEFAULT_SCALED = 1000  # ref methods/sourmash.py:30


def max_hash_for_scaled(scaled: int) -> int:
    """sourmash's scaled -> max_hash mapping (float64 rounding included).

    Matches the ``max_hash`` recorded in reference fixture .sig files:

    >>> max_hash_for_scaled(300)
    61489146912365176
    >>> max_hash_for_scaled(1000)
    18446744073709552
    >>> max_hash_for_scaled(1)
    18446744073709551615
    """
    if scaled <= 0:
        msg = f"scaled must be positive, got {scaled}"
        raise ValueError(msg)
    if scaled == 1:
        return 2**64 - 1
    return min(int(round(2**64 / scaled, 0)), 2**64 - 1)


@dataclass(frozen=True)
class Sketch:
    """A FracMinHash sketch: sorted unique retained hashes."""

    md5: str
    ksize: int
    scaled: int
    hashes: np.ndarray  # sorted unique uint64

    @property
    def num_hashes(self) -> int:
        return int(self.hashes.size)


def sketch_genome(genome: Genome, ksize: int = DEFAULT_KMER, scaled: int = DEFAULT_SCALED) -> Sketch:
    """FracMinHash sketch of a genome (all sequences pooled).

    Uses the native C++ hashing kernel when available (bit-identical to
    the numpy path; parity-tested), falling back to numpy otherwise.
    """
    from pyani_plus_tpu_torch.native import sketch_codes_native

    max_hash = np.uint64(max_hash_for_scaled(scaled))
    kept: list[np.ndarray] = []
    for rec in genome.records:
        h = sketch_codes_native(rec.codes, ksize, int(max_hash))
        if h is None:
            h = canonical_kmer_hashes(rec.codes, ksize)
            h = h[h <= max_hash]
        if h.size:
            kept.append(h)
    if kept:
        hashes = np.unique(np.concatenate(kept))
    else:
        hashes = np.empty(0, np.uint64)
    return Sketch(md5=genome.md5, ksize=ksize, scaled=scaled, hashes=hashes)


def intersection_matrix_host(sketches: list[Sketch]) -> np.ndarray:
    """All-pairs |A n B| via sparse matmul on host. Returns (N, N) int64."""
    from scipy import sparse

    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.int64)
    all_hashes = np.concatenate([s.hashes for s in sketches]) if any(
        s.hashes.size for s in sketches
    ) else np.empty(0, np.uint64)
    if all_hashes.size == 0:
        return np.zeros((n, n), dtype=np.int64)
    _, inverse = np.unique(all_hashes, return_inverse=True)
    rows = np.repeat(np.arange(n), [s.hashes.size for s in sketches])
    data = np.ones(all_hashes.size, dtype=np.int64)
    m = sparse.csr_matrix(
        (data, (rows, inverse)), shape=(n, int(inverse.max()) + 1 if inverse.size else 1)
    )
    return np.asarray((m @ m.T).todense(), dtype=np.int64)


# Calls of the device Gram that ran on CUDA (a plain integer;
# reset_counts() zeroes it).
LAUNCHES = 0


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def incidence(sketches: list[Sketch], block: int) -> np.ndarray:
    """The (nblocks, p_max) int32 flat scatter indices of each id block.

    As the JAX package prepares them: the union of all hashes gives each
    hash an id, and :func:`block_indices` cuts the (genome, id) pairs
    into blocks.
    """
    n = len(sketches)
    sizes = [s.hashes.size for s in sketches]
    all_hashes = np.concatenate([s.hashes for s in sketches])
    _, inverse = np.unique(all_hashes, return_inverse=True)
    rows = np.repeat(np.arange(n, dtype=np.int64), sizes)
    return block_indices(rows, inverse, n, block)


def block_indices(rows: np.ndarray, ids: np.ndarray, n: int, block: int) -> np.ndarray:
    """The (row, id) entries of an (n, ids) {0,1} membership matrix as
    :func:`gram`'s indices: ids are cut into blocks of ``block``, and each
    block's entries become indices ``row * block + id % block`` into the
    block's flattened (n, block) membership. The pad value ``n * block``
    scatters into one spare slot."""
    nblocks = -(-(int(ids.max()) + 1) // block)
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    rows_sorted = rows[order]
    per_block = np.bincount(ids_sorted // block, minlength=nblocks)
    flat = (rows_sorted * block + (ids_sorted % block)).astype(np.int32)
    pts = np.full((nblocks, int(per_block.max())), n * block, dtype=np.int32)
    offsets = np.concatenate(([0], np.cumsum(per_block)))
    for b in range(nblocks):
        seg = flat[offsets[b] : offsets[b + 1]]
        pts[b, : seg.size] = seg
    return pts


def _rows_indices(pts: torch.Tensor, lo: int, hi: int, block: int) -> torch.Tensor:
    """``block_indices``'s flat indices re-based onto the rows [lo, hi) of
    each block's membership; entries of other rows, and the pad, go to the
    one spare slot past them."""
    local = pts - lo * block
    spare = (hi - lo) * block
    return torch.where((local >= 0) & (local < spare), local, spare)


def gram(pts, n: int, block: int, mesh=None) -> np.ndarray:
    """The (n, n) int64 counts from :func:`block_indices`'s indices (a
    numpy array or a tensor), over ``mesh`` (default: the one device that
    ``pts`` lies on).

    Device (i, j) of the mesh scatters each block's membership of its "q"
    rows and of its "s" rows (one scatter on the diagonal) and accumulates
    their float32 products in a float64 tile; the tiles are gathered on
    the mesh's first device and copied to the host. Blocks go round the devices in turn, so that devices that
    are distinct cards work at the same time.
    """
    from pyani_plus_tpu_torch.parallel.tiles import make_mesh, mesh_tiles

    pts = torch.as_tensor(pts)
    if mesh is None:
        mesh = make_mesh(devices=[pts.device])
    on_device: dict[torch.device, torch.Tensor] = {}
    work = []
    for device, (r0, r1), (c0, c1) in mesh_tiles(n, mesh):
        if r0 == r1 or c0 == c1:
            continue
        if device not in on_device:
            on_device[device] = pts.to(device).long()
        q_idx = _rows_indices(on_device[device], r0, r1, block)
        s_idx = q_idx if (c0, c1) == (r0, r1) else _rows_indices(on_device[device], c0, c1, block)
        q_mem = torch.empty((r1 - r0) * block + 1, dtype=torch.float32, device=device)
        s_mem = q_mem if s_idx is q_idx else torch.empty(
            (c1 - c0) * block + 1, dtype=torch.float32, device=device
        )
        product = torch.empty((r1 - r0, c1 - c0), dtype=torch.float32, device=device)
        tile = torch.zeros((r1 - r0, c1 - c0), dtype=torch.float64, device=device)
        work.append(((r0, r1, c0, c1), q_idx, s_idx, q_mem, s_mem, product, tile))
    for b in range(pts.shape[0]):
        for (r0, r1, c0, c1), q_idx, s_idx, q_mem, s_mem, product, tile in work:
            q_mem.zero_()
            q_mem.index_fill_(0, q_idx[b], 1.0)
            if s_mem is not q_mem:  # off the diagonal
                s_mem.zero_()
                s_mem.index_fill_(0, s_idx[b], 1.0)
            q = q_mem[:-1].view(r1 - r0, block)
            s = s_mem[:-1].view(c1 - c0, block)
            torch.matmul(q, s.T, out=product)
            tile += product
    # the tiles meet on the mesh's first device, so the host takes one copy
    counts = torch.empty((n, n), dtype=torch.int64, device=mesh.devices.flat[0])
    for (r0, r1, c0, c1), *_, tile in work:
        counts[r0:r1, c0:c1] = tile.to(counts.device, torch.int64)
    return counts.cpu().numpy()  # synchronises


def intersection_matrix_device(
    sketches: list[Sketch],
    *,
    block: int = 4096,
    device: torch.device | str | None = None,
    mesh="auto",
) -> np.ndarray:
    """All-pairs ``|A n B|`` by blocked membership products. Returns (N,
    N) int64. The host's preparation is the span ``gram.prepare``, the
    Gram from its submit to the counts on the host ``gram.device`` where
    the mesh holds a card.

    ``mesh="auto"`` splits the counts over ``default_pair_mesh()`` (every
    card of a process that has several); ``mesh=None``, or a ``device``,
    keeps them on one device (default: ``backend.kernel_device()``, this
    process's card unless the CPU is requested).
    """
    global LAUNCHES
    from pyani_plus_tpu_torch.parallel.tiles import default_pair_mesh, make_mesh

    if not 0 < block < 1 << 24:
        msg = f"block must be in [1, 2^24), got {block}"
        raise ValueError(msg)
    if device is not None and mesh not in ("auto", None):
        msg = "give intersection_matrix_device a device or a mesh, not both"
        raise ValueError(msg)
    if mesh == "auto":
        mesh = default_pair_mesh() if device is None else None
    if mesh is None:
        mesh = make_mesh(devices=[device if device is not None else backend.kernel_device()])
    n = len(sketches)
    if sum(s.hashes.size for s in sketches) == 0:
        return np.zeros((n, n), dtype=np.int64)
    with spans.span("gram.prepare"):
        pts = incidence(sketches, block)
    on_card = any(d.type == "cuda" for d in mesh.devices.flat)
    with spans.span("gram.device") if on_card else contextlib.nullcontext():
        out = gram(pts, n, block, mesh)
    if on_card:
        LAUNCHES += 1
    return out


def ani_from_counts(inter: np.ndarray, sketches: list[Sketch], ksize: int) -> tuple[np.ndarray, np.ndarray]:
    """(identity, cov_query) from the intersection counts, as the JAX
    package's ``containment_ani`` computes them (the same numpy steps, so
    the same floats from the same counts)."""
    sizes = np.array([s.hashes.size for s in sketches], dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        c_q = inter / sizes[:, None]  # containment of query (row) in subject
        c_s = inter / sizes[None, :]  # containment of subject in query
        c_max = np.maximum(c_q, c_s)
        identity = np.power(c_max, 1.0 / ksize)
        cov = np.power(c_q, 1.0 / ksize)
    # Zero intersection or empty sketches -> failed alignment -> NaN
    bad = (inter == 0) | ~np.isfinite(c_q) | ~np.isfinite(c_max)
    identity[bad] = np.nan
    cov[bad] = np.nan
    return identity, cov


def containment_ani(
    sketches: list[Sketch], *, use_device: bool | None = None, mesh="auto"
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (identity, cov_query) matrices for the sourmash method.

    identity[q, s] = max(c_qs, c_sq) ** (1/k), cov[q, s] = c_qs ** (1/k),
    where c_qs = |Q n S| / |Q|; NaN where nothing is shared. By default
    the counts come from the device Gram for at least 64 sketches holding
    more than 2^18 hashes in all, and from the host Gram otherwise (the
    JAX package's threshold). ``mesh`` is the device Gram's.
    """
    n = len(sketches)
    ksize = sketches[0].ksize if sketches else DEFAULT_KMER
    if use_device is None:
        total = sum(s.hashes.size for s in sketches)
        use_device = n >= 64 and total > 1 << 18
    inter = (
        intersection_matrix_device(sketches, mesh=mesh)
        if use_device
        else intersection_matrix_host(sketches)
    )
    return ani_from_counts(inter, sketches, ksize)


# ---------------------------------------------------------------------------
# Device sketching. A genome's code bytes are the only host->device traffic;
# validity, canonical choice, hashing and the scaled filter run on the
# device and only the kept hashes come back. The host sorts and dedupes
# them (np.unique), as the JAX package does.
# ---------------------------------------------------------------------------

_DEV_CHUNK_W = 1 << 18  # windows per chunk row
_DEV_BATCH = 4  # chunk rows per device call
_MAX_K = 32  # the packed k-mer fills an int64 at k = 32
_SIGN = -(1 << 63)  # x ^ _SIGN maps unsigned order onto signed order
_ASCII = (ord("A"), ord("C"), ord("G"), ord("T"))


def _sketch_rows(codes: torch.Tensor, k: int, max_hash: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kept hashes of a (B, W + k - 1) uint8 batch of chunk rows.

    The body of the JAX package's ``_device_sketch_fn``. Returns the int64
    bit patterns of every valid window's canonical-k-mer hash that is
    ``<= max_hash`` (unsigned), row by row, and each row's count.
    """
    b, width = codes.shape
    w = width - k + 1
    device = codes.device
    # a window is valid when none of its k codes is 4 or more (N, IUPAC)
    invalid = torch.nn.functional.pad(torch.cumsum(codes >= 4, dim=1, dtype=torch.int32), (1, 0))
    valid = (invalid[:, k:] - invalid[:, :-k]) == 0
    fwd_codes = codes.clamp(max=3).to(torch.int64)
    rev_codes = 3 - fwd_codes
    # canonical choice: big-endian 2-bit packs of the k-mer and its
    # reverse complement; at k = 32 they fill all 64 bits, so compare
    # them as unsigned
    fwd = torch.zeros((b, w), dtype=torch.int64, device=device)
    rev = torch.zeros((b, w), dtype=torch.int64, device=device)
    for j in range(k):
        fwd |= fwd_codes[:, j : j + w] << (2 * (k - 1 - j))
        rev |= rev_codes[:, j : j + w] << (2 * j)
    take_rc = (rev ^ _SIGN) < (fwd ^ _SIGN)
    del fwd, rev
    # the canonical k-mer's ASCII bytes as little-endian words: byte p is
    # the forward letter at i + p or the complement's at i + k - 1 - p
    ascii_ = torch.tensor(_ASCII, dtype=torch.int64, device=device)
    fwd_bytes = ascii_[fwd_codes]
    rev_bytes = ascii_[rev_codes]
    words = []
    for base in range(0, k, 8):
        word_f = torch.zeros((b, w), dtype=torch.int64, device=device)
        word_r = torch.zeros((b, w), dtype=torch.int64, device=device)
        for t in range(min(8, k - base)):
            p = base + t
            word_f |= fwd_bytes[:, p : p + w] << (8 * t)
            word_r |= rev_bytes[:, k - 1 - p : k - 1 - p + w] << (8 * t)
        words.append(torch.where(take_rc, word_r, word_f))
    hashes = murmur64_words(words, k)
    keep = valid & ((hashes ^ _SIGN) <= signed64(max_hash ^ (1 << 63)))
    return hashes[keep], keep.sum(dim=1)


def sketch_genomes_device(
    genomes: list[Genome],
    ksize: int = DEFAULT_KMER,
    scaled: int = DEFAULT_SCALED,
    *,
    chunk_w: int = _DEV_CHUNK_W,
    batch: int = _DEV_BATCH,
) -> list[Sketch]:
    """FracMinHash sketches computed on the device; bit-identical to
    ``sketch_genome``.

    Each record is cut into chunks of ``chunk_w`` windows (``chunk_w + k
    - 1`` codes, the last padded with code 4); chunks of all genomes pool
    into device calls of ``batch`` rows.
    """
    if ksize > _MAX_K:
        msg = f"k={ksize} exceeds packing limit {_MAX_K}"
        raise ValueError(msg)
    max_hash = max_hash_for_scaled(scaled)
    device = backend.kernel_device()
    width = chunk_w + ksize - 1
    chunks: list[np.ndarray] = []
    owner: list[int] = []
    for gi, genome in enumerate(genomes):
        for rec in genome.records:
            codes = rec.codes
            if codes.size < ksize:
                continue
            for start in range(0, codes.size - ksize + 1, chunk_w):
                piece = codes[start : start + width]
                if piece.size < width:
                    piece = np.concatenate([piece, np.full(width - piece.size, 4, np.uint8)])
                chunks.append(piece)
                owner.append(gi)
    kept: dict[int, list[np.ndarray]] = {}
    for base in range(0, len(chunks), batch):
        rows = torch.from_numpy(np.stack(chunks[base : base + batch])).to(device)
        hashes, counts = _sketch_rows(rows, ksize, max_hash)
        parts = np.split(to_uint64(hashes), np.cumsum(counts.cpu().numpy())[:-1])
        for row, part in enumerate(parts):
            if part.size:
                kept.setdefault(owner[base + row], []).append(part)
    out = []
    for gi, genome in enumerate(genomes):
        parts = kept.get(gi)
        hashes = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.uint64)
        out.append(Sketch(md5=genome.md5, ksize=ksize, scaled=scaled, hashes=hashes))
    return out


def sketch_genome_device(
    genome: Genome,
    ksize: int = DEFAULT_KMER,
    scaled: int = DEFAULT_SCALED,
    *,
    chunk_w: int = _DEV_CHUNK_W,
    batch: int = _DEV_BATCH,
) -> Sketch:
    """Single-genome convenience wrapper over :func:`sketch_genomes_device`."""
    return sketch_genomes_device([genome], ksize, scaled, chunk_w=chunk_w, batch=batch)[0]
