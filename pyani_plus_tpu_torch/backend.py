"""The port's device: the caller's choice, and a probe of the card.

Replaces the JAX package's backend checks on the ported path
(``extend_pallas._is_tpu_backend`` and the CLI's ``JAX_PLATFORMS``
override). Every compute path of the port runs on the card unless the
caller asks for the CPU with ``PYANI_TPU_TORCH_DEVICE=cpu``: the variable
is read here, when a device is needed, and nowhere else. With the card
requested (``cuda``, the default) and none found, or one that is not
sm_90, resolving the device raises; nothing carries on on the CPU alone.

:func:`probe` is a report, taken once per process and logged once, so
every run's log says which device and compiler the kernels met. It
decides nothing.
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
# The caller's device choice: "cuda" (the default) or "cpu"
ENV_DEVICE = "PYANI_TPU_TORCH_DEVICE"
DEVICE_CHOICES = ("cuda", "cpu")


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


def requested_device() -> str:
    """The caller's choice, read now: ``cuda`` when the variable is unset,
    or ``cpu``. Any other value raises."""
    value = os.environ.get(ENV_DEVICE, "cuda")
    if value not in DEVICE_CHOICES:
        msg = f"{ENV_DEVICE}={value!r}: expected 'cuda' (the default) or 'cpu'"
        raise ValueError(msg)
    return value


def cards() -> list[torch.device]:
    """This process's cards when the card is requested, else none. Never
    raises: a path that needs a card resolves it with :func:`kernel_device`."""
    if requested_device() == "cpu" or not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def check_capability(device: torch.device, what: str = "pyani_plus_tpu_torch") -> None:
    """Raise unless the card is one the sm_90a kernels run on."""
    capability = tuple(torch.cuda.get_device_capability(device))
    if capability != KERNEL_CAPABILITY:
        msg = (
            f"{what}: the kernels are built for sm_90a; this device is "
            f"{torch.cuda.get_device_name(device)} with capability {capability}"
        )
        raise RuntimeError(msg)


def _no_card(alternative: str) -> RuntimeError:
    return RuntimeError(
        f"no CUDA device was found; {alternative}set {ENV_DEVICE}=cpu to run on the CPU"
    )


def kernel_devices(alternative: str = "") -> list[torch.device]:
    """Every device the kernels may run on in this process: the CPU when
    it is requested, else every card, each checked. ``alternative`` is
    put in the refusal before the variable (another way out, such as an
    argument that names the devices)."""
    if requested_device() == "cpu":
        return [torch.device("cpu")]
    found = cards()
    if not found:
        raise _no_card(alternative)
    for card in found:
        check_capability(card)
    return found


def kernel_device(alternative: str = "") -> torch.device:
    """Where the batched kernels run: the CPU when it is requested, else
    the current card, checked. A worker of a process group has made its
    own card current (``parallel/distributed.maybe_initialize``). Raises
    when the card is requested and there is none."""
    if requested_device() == "cpu":
        return torch.device("cpu")
    if not cards():
        raise _no_card(alternative)
    device = torch.device("cuda", torch.cuda.current_device())
    check_capability(device)
    return device


def on_card() -> bool:
    """True when the work goes to the card; False when the CPU is
    requested. Raises when the card is requested and absent."""
    return kernel_device().type == "cuda"
