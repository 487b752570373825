"""Explicit device probe: CUDA, compute capability, nvcc and the card.

Replaces the JAX package's backend checks on the ported path
(``extend_pallas._is_tpu_backend`` and the CLI's platform override). The
report is taken once per process and logged once, so every run's log
says which device and compiler the kernels met.
"""

from __future__ import annotations

import functools
import logging
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

# The kernels are built for sm_90a: Hopper only.
KERNEL_CAPABILITY = (9, 0)


@dataclass(frozen=True)
class DeviceReport:
    cuda: bool
    capability: tuple[int, int] | None
    device_name: str | None
    device_count: int
    torch_version: str
    torch_cuda: str | None
    nvcc: str | None
    nvcc_version: str | None
    smi: str | None  # nvidia-smi's "name, power.limit" line

    @property
    def kernels_supported(self) -> bool:
        """True when the hand-written sm_90a kernels can run here."""
        return self.cuda and self.capability == KERNEL_CAPABILITY

    def lines(self) -> list[str]:
        return [
            f"torch {self.torch_version} (CUDA {self.torch_cuda})",
            f"cuda available: {self.cuda}, devices: {self.device_count}",
            f"device: {self.device_name}, capability: {self.capability}",
            f"nvcc: {self.nvcc} ({self.nvcc_version})",
            f"nvidia-smi: {self.smi}",
        ]


def nvcc_path() -> str | None:
    """The CUDA compiler: $CUDA_HOME or $CUDA_PATH, then PATH, then the
    toolkit's default install prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def _command_output(cmd: list[str]) -> str | None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return proc.stdout.strip() or None


@functools.lru_cache(maxsize=1)
def probe() -> DeviceReport:
    """Probe once per process and log the report."""
    cuda = torch.cuda.is_available()
    nvcc = nvcc_path()
    nvcc_version = None
    if nvcc:
        out = _command_output([nvcc, "--version"])
        nvcc_version = out.splitlines()[-1] if out else None
    smi = None
    if shutil.which("nvidia-smi"):
        out = _command_output(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ]
        )
        smi = out.splitlines()[0] if out else None
    report = DeviceReport(
        cuda=cuda,
        capability=tuple(torch.cuda.get_device_capability(0)) if cuda else None,
        device_name=torch.cuda.get_device_name(0) if cuda else None,
        device_count=torch.cuda.device_count() if cuda else 0,
        torch_version=torch.__version__,
        torch_cuda=torch.version.cuda,
        nvcc=nvcc,
        nvcc_version=nvcc_version,
        smi=smi,
    )
    logger = logging.getLogger(__name__)
    for line in report.lines():
        logger.info("backend: %s", line)
    return report


def kernel_device() -> torch.device:
    """Where the batched kernels run: the current card when CUDA is
    present, the CPU otherwise. A worker of a process group has made its
    own card current (``parallel/distributed.maybe_initialize``)."""
    return torch.device("cuda", torch.cuda.current_device()) if probe().cuda else torch.device("cpu")
