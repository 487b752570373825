"""Kernel wrappers and their plain PyTorch versions.

Each wrapper launches its hand-written kernel for tensors on a CUDA
device and uses the plain PyTorch version only for tensors on the CPU.
The JAX-free numpy ops (seeding, chaining, gap fills) are imported from
``pyani_plus_tpu.ops`` where they are used.
"""
