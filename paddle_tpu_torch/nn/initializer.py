"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each is a callable ``(shape, dtype=None, device=None, generator=None)``
returning a new torch tensor drawn from ``generator``, by default the
port's generator of ``device`` (``core/random.py``), so ``paddle.seed``
fixes every layer's initial weights. The distributions and their fan
rules are the JAX package's (Paddle's ``[in, out]`` linear weights:
``fan_in = shape[0]``; convolution weights ``[out, in / groups, k...]``:
``fan_in = shape[1] * prod(k)``); the numbers are PyTorch's.
"""
from __future__ import annotations

import math

import torch

from ..core import dtypes as _dt
from ..core import random as _rng
from ..core.device import to_torch_device

__all__ = ["Initializer", "Constant", "Uniform", "XavierUniform",
           "XavierNormal", "KaimingUniform"]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=None, device=None, generator=None):
        dev = to_torch_device(device)
        out = torch.empty([int(s) for s in shape],
                          dtype=_dt.convert_dtype(dtype)
                          or _dt.get_default_dtype(), device=dev)
        with torch.no_grad():
            self._fill(out, generator or _rng.generator(dev))
        return out

    def _fill(self, out, gen):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, out, gen):
        out.fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, out, gen):
        out.uniform_(self.low, self.high, generator=gen)


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self._fan_in if self._fan_in is not None else fi,
                self._fan_out if self._fan_out is not None else fo)


class XavierUniform(_Xavier):
    def _fill(self, out, gen):
        fi, fo = self._fans(out.shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        out.uniform_(-limit, limit, generator=gen)


class XavierNormal(_Xavier):
    def _fill(self, out, gen):
        fi, fo = self._fans(out.shape)
        out.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                    generator=gen)


class KaimingUniform(Initializer):
    """Paddle's Kaiming: gain ``sqrt(2 / (1 + negative_slope^2))`` for
    ``leaky_relu`` (the default, slope 0: ``sqrt(2)``), limit ``gain *
    sqrt(3 / fan_in)``. Not torch's ``kaiming_uniform_(a=sqrt(5))``."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "relu":
            return math.sqrt(2.0)
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return 1.0

    def _fill(self, out, gen):
        fan_in = self._fan_in if self._fan_in is not None \
            else _fan_in_out(out.shape)[0]
        limit = self._gain() * math.sqrt(3.0 / fan_in)
        out.uniform_(-limit, limit, generator=gen)
