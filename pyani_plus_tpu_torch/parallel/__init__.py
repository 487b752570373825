"""The port's run driver (single process for now)."""

from pyani_plus_tpu_torch.parallel.runner import resume_run, start_and_run_method

__all__ = ["resume_run", "start_and_run_method"]
