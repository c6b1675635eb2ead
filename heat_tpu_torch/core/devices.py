"""Device abstraction (counterpart of ``heat_tpu/core/devices.py``).

A :class:`Device` is a label that resolves to a ``torch.device``. The
default device is the first CUDA card (``gpu:0`` -> ``cuda:0``); work moves
to the CPU only when the caller asks for it, with ``use_device("cpu")`` or
``device="cpu"`` on a factory. Resolving a CUDA device on a machine without
one raises: the port never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "use_device", "sanitize_device"]

_GPU_NAMES = ("gpu", "cuda")


class Device:
    """A compute device label.

    Parameters
    ----------
    device_type : str
        ``"cpu"`` or ``"gpu"`` (``"cuda"`` is accepted as an alias).
    device_id : int
        Card index for ``"gpu"``.
    """

    def __init__(self, device_type: str, device_id: int = 0):
        device_type = str(device_type).lower()
        if device_type in _GPU_NAMES:
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"Unknown device type {device_type!r}, must be 'cpu' or 'gpu'")
        self.__device_type = device_type
        self.__device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        return self.__device_id

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` for this label. Raises RuntimeError for a
        ``gpu`` label when torch sees no CUDA card."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "heat_tpu_torch: no CUDA device is available and the CPU was not "
                "requested; call heat_tpu_torch.use_device('cpu') or pass device='cpu'"
            )
        if self.__device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"heat_tpu_torch: CUDA device {self.__device_id} requested, "
                f"{torch.cuda.device_count()} available"
            )
        return torch.device("cuda", self.__device_id)

    def __repr__(self) -> str:
        return f"device({self.__str__()!r})"

    def __str__(self) -> str:
        return f"{self.device_type}:{self.device_id}"

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type and self.device_id == other.device_id
        if isinstance(other, str):
            return str(self) == other or self.device_type == other
        return NotImplemented

    def __hash__(self):
        return hash(str(self))


cpu = Device("cpu")
"""The CPU device singleton."""

gpu = Device("gpu", 0)
"""The first CUDA card: the default device."""

__default_device: Device = gpu


def get_device() -> Device:
    """The currently globally-set default device."""
    return __default_device


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the global default device (``None`` restores ``gpu``)."""
    global __default_device
    __default_device = gpu if device is None else sanitize_device(device)


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Default-or-validate a device argument."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        return cpu if device.type == "cpu" else Device("gpu", device.index or 0)
    if isinstance(device, str):
        name, _, idx = device.lower().partition(":")
        if name == "cpu":
            return cpu
        if name in _GPU_NAMES:
            return Device("gpu", int(idx) if idx else 0)
    raise ValueError(f"Unknown device, must be 'cpu' or 'gpu'/'cuda[:i]', got {device}")
