"""Kernel wrappers, their plain PyTorch versions and the numpy host ops.

Each wrapper launches its hand-written kernel for tensors on a CUDA
device and uses the plain PyTorch version only for tensors on the CPU.
The numpy host ops (seeding, chaining, gap fills, the extension oracle,
k-mer hashing) keep the JAX package's module names.
"""
