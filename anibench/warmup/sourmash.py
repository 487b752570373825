"""sourmash's warm-up: one run of the runner over two of the cell's
genomes cut to 300 kb (the native sketch library, the store), then one
device Gram at the cell's N on sketches of the cell's size (the card's
context, the scatter and the float32 product at these shapes)."""

from __future__ import annotations

import numpy as np

from anibench.gen import rng_for, truncated_copy

WARM_LENGTH = 300_000


def warm(*, program, paths, work, run, config) -> None:
    for path in paths[:2]:
        truncated_copy(path, work / "genomes", WARM_LENGTH)
    run(work / "genomes", work / "warm.db", work / "cache")
    minhash = program["minhash"]
    rng = rng_for(0, 7)
    per_genome = max(1, config["genome_length"] // config["params"]["scaled"])
    pool = np.unique(rng.integers(0, 2**63, per_genome * 4, dtype=np.uint64))
    sketches = [
        minhash.Sketch(f"warm{i}", config["params"]["kmersize"], config["params"]["scaled"],
                       np.sort(rng.choice(pool, per_genome, replace=False)))
        for i in range(len(paths))
    ]
    minhash.intersection_matrix_device(sketches)
