"""The benchmark of the PyTorch/CUDA port (``pyani_plus_tpu_torch``).

``python -m anibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
times whole all-vs-all runs through the port's runner on one CUDA card
and judges every stored row against the plain references in
``anibench/reference``. See ``anibench/README.md``.
"""
