"""sourmash-mode ANI: FracMinHash containment, with the Gram on the card.

Port of ``pyani_plus_tpu/methods/sourmash.py``. The configuration, the
parameters and the sketching (``get_sketch``: the native host sketch with
its ``.npy`` cache) are the JAX package's own, imported, so a run of
either package resumes under the other. Only ``compute`` is ported: it
scores with this package's ``containment_ani``, whose all-pairs counts go
to the device Gram at the JAX package's threshold (at least 64 genomes
and more than 2^18 hashes in all).
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu.methods.sourmash import (
    KMER_SIZE,
    NAME,
    PROGRAM,
    SCALED,
    WHOLE_MATRIX,
    _scaled_from_extra,
    configuration,
    get_sketch,
)
from pyani_plus_tpu_torch.methods import ComputeContext
from pyani_plus_tpu_torch.ops.minhash import containment_ani

__all__ = [
    "KMER_SIZE",
    "NAME",
    "PROGRAM",
    "SCALED",
    "WHOLE_MATRIX",
    "compute",
    "configuration",
]


def compute(ctx: ComputeContext) -> list[dict]:
    """Compute the full query x subject containment tile."""
    kmersize = ctx.config.get("kmersize") or KMER_SIZE
    scaled = _scaled_from_extra(ctx.config.get("extra"))

    hashes = sorted(set(ctx.query_hashes) | set(ctx.subject_hashes))
    sketches = [
        get_sketch(ctx.genomes[h], kmersize, scaled, ctx.cache) for h in hashes
    ]
    identity, cov = containment_ani(sketches)
    index = {h: i for i, h in enumerate(hashes)}

    rows: list[dict] = []
    for q, s in ctx.pending:
        i, j = index[q], index[s]
        ident = identity[i, j]
        c = cov[i, j]
        rows.append(
            {
                "query_hash": q,
                "subject_hash": s,
                "identity": None if np.isnan(ident) else float(ident),
                "cov_query": None if np.isnan(c) else float(c),
                "aln_length": None,
                "sim_errors": None,
                "cov_subject": None,
            }
        )
    ctx.tick(len(rows))
    return rows
