"""The port's random state: one ``torch.Generator`` per device.

Counterpart of ``paddle_tpu/core/random.py``. ``seed(n)`` reseeds every
device's generator (and those made later start from ``n``); creation
ops and initializers draw from :func:`generator` of their device, so a
model built after ``seed(n)`` is the same every time. The numbers are
PyTorch's, not ``jax.random``'s: weights pass between the packages as
arrays, never as seeds.
"""
from __future__ import annotations

from typing import Dict

import torch

from .device import to_torch_device

__all__ = ["seed", "generator", "get_rng_state", "set_rng_state"]

_GENERATORS: Dict[torch.device, torch.Generator] = {}
_SEED = [0]


def generator(device=None) -> torch.Generator:
    """The default generator of ``device`` (the current device if
    ``None``), made at first use from the last ``seed``."""
    dev = to_torch_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(_SEED[0])
        _GENERATORS[dev] = gen
    return gen


def seed(n: int) -> torch.Generator:
    """``paddle.seed``: reseed every generator with ``n``; returns the
    current device's."""
    _SEED[0] = int(n)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED[0])
    return generator()


def get_rng_state(device=None) -> torch.Tensor:
    return generator(device).get_state()


def set_rng_state(state: torch.Tensor, device=None) -> None:
    generator(device).set_state(state)
