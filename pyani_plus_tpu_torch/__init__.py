"""pyANI-plus-TPU on PyTorch and CUDA: the port for one NVIDIA H100.

A second package beside ``pyani_plus_tpu`` (the JAX reference, which
stays as it is). It mirrors that package's layout so that each module
has an obvious counterpart, imports every JAX-free module from it
(genome ingest, the store, reports, the native host kernels, the numpy
ops) instead of copying them, and owns only the call chains that reach
JAX there. Each Pallas kernel on a ported path becomes a kernel written
by hand for Hopper under ``csrc/``, built with nvcc at first use.

Layout:

- ``backend.py``  -- explicit CUDA/nvcc/device probe
- ``csrc/``       -- the hand-written CUDA kernels
- ``ops/``        -- kernel builds, wrappers and their plain PyTorch versions
- ``methods/``    -- the ported methods (ANIm, dnadiff, ANIb)
- ``parallel/``   -- the run driver
- ``cli/``        -- the ``pyani-plus-tpu-torch`` command line
"""

from __future__ import annotations

# One version for both packages: configuration rows and the resume
# version check match, so a run started by one resumes under the other.
from pyani_plus_tpu import __version__

__all__ = ["__version__"]
