"""Paddle's device API over the port's device rule.

Counterpart of ``paddle_tpu/core/device.py``. Every entry point runs on
the card unless its caller asks for the CPU (:func:`resolve_device`).
``set_device`` takes Paddle's names (``"gpu"``, ``"gpu:1"``, ``"cpu"``;
``"cuda"`` and ``"tpu"`` too) or a :class:`Place`, and the current
device is where creation ops and layers put their tensors. Until
``set_device`` is called it is the card, which raises on a machine
without CUDA unless the caller asks for the CPU. ``TPUPlace(i)`` names
the card ``cuda:i``: in the JAX package it names the accelerator.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "TPUPlace", "set_device",
           "get_device", "current_device", "current_place", "device_count",
           "to_torch_device", "is_compiled_with_tpu"]

_CURRENT: list = [None]

# Paddle's and the JAX package's names of the accelerator
_ACCELERATORS = ("gpu", "cuda", "tpu")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is returned as a
    ``torch.device``. Raises ``RuntimeError`` when a CUDA device is
    asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path on "
            "the host")
    return dev


class Place:
    """A device identity: platform (``"cpu"``, ``"gpu"``) and index."""

    __slots__ = ("platform", "index")

    def __init__(self, platform: str, index: int = 0):
        self.platform = platform
        self.index = index

    def __repr__(self):
        return f"Place({self.platform}:{self.index})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.platform == other.platform
                and self.index == other.index)

    def __hash__(self):
        return hash((self.platform, self.index))

    def is_cpu_place(self):
        return self.platform == "cpu"

    def is_gpu_place(self):
        return self.platform in _ACCELERATORS

    is_tpu_place = is_gpu_place


def CPUPlace(index: int = 0) -> Place:  # noqa: N802 - Paddle's name
    return Place("cpu", index)


def TPUPlace(index: int = 0) -> Place:  # noqa: N802 - Paddle's name
    """The card ``cuda:index``, the port's accelerator."""
    return Place("gpu", index)


def is_compiled_with_tpu() -> bool:
    """Whether the port's accelerator, a CUDA card, is present."""
    return torch.cuda.is_available()


def to_torch_device(device) -> torch.device:
    """A ``torch.device`` for a Paddle device name (``gpu``/``gpu:i``,
    ``tpu``/``tpu:i`` -> ``cuda``/``cuda:i``), a :class:`Place`, a torch
    device or ``None`` (the current device). A place of another platform
    (``CUDAPinnedPlace``, ``NPUPlace``) raises ``RuntimeError``, as the
    JAX package's ``jax_device`` does for a backend it does not have."""
    if device is None:
        return current_device()
    if isinstance(device, Place):
        if not (device.is_cpu_place() or device.is_gpu_place()):
            raise RuntimeError(f"no device for {device!r}: the port runs "
                               "on the CPU and CUDA cards")
        device = "cpu" if device.is_cpu_place() else f"cuda:{device.index}"
    if isinstance(device, str):
        name, _, index = device.lower().partition(":")
        if name in _ACCELERATORS:
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


def current_place() -> Place:
    """The current device as a :class:`Place`."""
    dev = current_device()
    if dev.type == "cuda":
        return Place("gpu", dev.index or 0)
    return Place(dev.type, dev.index or 0)


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
