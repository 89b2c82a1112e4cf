"""Paddle's device API over the port's device rule.

Counterpart of ``paddle_tpu/core/device.py``. ``set_device`` takes
Paddle's names (``"gpu"``, ``"gpu:1"``, ``"cpu"``; ``"cuda"`` too) and
the current device is where creation ops and layers put their tensors.
Until ``set_device`` is called it is the card: the rule of
:func:`~paddle_tpu_torch.device.resolve_device`, which raises on a
machine without CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["set_device", "get_device", "current_device", "device_count",
           "to_torch_device"]

_CURRENT: list = [None]


def to_torch_device(device) -> torch.device:
    """A ``torch.device`` for a Paddle device name (``gpu``/``gpu:i`` ->
    ``cuda``/``cuda:i``), a torch device or ``None`` (the current
    device)."""
    if device is None:
        return current_device()
    if isinstance(device, str):
        name, _, index = device.lower().partition(":")
        if name == "gpu":
            name = "cuda"
        device = f"{name}:{index}" if index else name
    return resolve_device(device)


def set_device(device) -> torch.device:
    """``paddle.set_device``: make ``device`` current and return it."""
    _CURRENT[0] = to_torch_device(device)
    return _CURRENT[0]


def current_device() -> torch.device:
    """The current device: the one ``set_device`` chose, else the card
    (raises without CUDA)."""
    return _CURRENT[0] if _CURRENT[0] is not None else resolve_device()


def get_device() -> str:
    """Paddle's name of the current device: ``"gpu:0"`` or ``"cpu"``."""
    dev = current_device()
    if dev.type == "cuda":
        return f"gpu:{dev.index or 0}"
    return dev.type


def device_count(platform: Optional[str] = None) -> int:
    """The number of CUDA devices (``platform="cpu"``: 1)."""
    if platform == "cpu":
        return 1
    return torch.cuda.device_count()
