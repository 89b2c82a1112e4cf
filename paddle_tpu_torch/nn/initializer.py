"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each is a callable ``(shape, dtype=None, device=None, generator=None)``
returning a new torch tensor drawn from ``generator``, by default the
port's generator of ``device`` (``core/random.py``), so ``paddle.seed``
fixes every layer's initial weights. The distributions and their fan
rules are the JAX package's (Paddle's ``[in, out]`` linear weights:
``fan_in = shape[0]``; convolution weights ``[out, in / groups, k...]``:
``fan_in = shape[1] * prod(k)``); the numbers are PyTorch's. ``Assign``
and ``Bilinear`` are deterministic and equal the JAX package's.
``Orthogonal`` and ``Dirac`` follow JAX's ``orthogonal`` and
``delta_orthogonal`` (orthonormal columns of the weight as a matrix of
its last axis; an orthogonal ``[shape[-2], shape[-1]]`` block at the
centre of the leading axes), drawn from torch's generator.
``set_global_initializer`` sets what ``create_parameter`` and
``Layer.create_parameter`` use when no initializer is given.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core import random as _rng
from ..core.device import to_torch_device

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
           "set_global_initializer"]


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


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, out, gen):
        out.normal_(self.mean, self.std, generator=gen)


class TruncatedNormal(Initializer):
    """A normal of ``mean`` and ``std`` truncated at two ``std`` either
    side of the mean (the JAX package's bounds), by inverting the CDF
    over a uniform draw."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, out, gen):
        # in float32 (or float64): erfinv is not there for every dtype
        w = out if out.dtype in (torch.float32, torch.float64) \
            else torch.empty(out.shape, dtype=torch.float32, device=out.device)
        lo = math.erf(-2.0 / math.sqrt(2.0))
        w.uniform_(lo, -lo, generator=gen)
        w.erfinv_().mul_(self.std * math.sqrt(2.0)).add_(self.mean)
        w.clamp_(self.mean - 2 * self.std, self.mean + 2 * self.std)
        out.copy_(w)


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


class KaimingNormal(KaimingUniform):
    """Normal of std ``gain / sqrt(fan_in)``."""

    def _fill(self, out, gen):
        fan_in = self._fan_in if self._fan_in is not None \
            else _fan_in_out(out.shape)[0]
        out.normal_(0.0, self._gain() / math.sqrt(fan_in), generator=gen)


class Assign(Initializer):
    """The given values (a tensor, array or list), in the parameter's
    shape and dtype."""

    def __init__(self, value):
        self.value = value

    def _fill(self, out, gen):
        v = self.value
        src = v.detach() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.array(v))
        out.copy_(src.reshape(out.shape).to(out.dtype))


def _orthogonal(shape, gen, device):
    """JAX's ``orthogonal()`` (column axis last): the weight as a
    ``[prod(shape[:-1]), shape[-1]]`` matrix with orthonormal columns
    (rows, when it is wide), from the QR of a normal draw, the signs of
    R's diagonal folded in."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    wide = n_rows < n_cols
    a = torch.empty((n_cols, n_rows) if wide else (n_rows, n_cols),
                    dtype=torch.float32, device=device)
    a.normal_(0.0, 1.0, generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.T if wide else q).reshape(shape)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _fill(self, out, gen):
        out.copy_(self.gain * _orthogonal(tuple(out.shape), gen, out.device))


class Dirac(Initializer):
    """The JAX package's ``Dirac``: JAX's ``delta_orthogonal`` over the
    weight's own axes, zeros but for an orthogonal ``[shape[-2],
    shape[-1]]`` block at the centre of the leading (spatial, in JAX's
    layout) axes; 3-, 4- or 5-D, ``shape[-2] <= shape[-1]``. ``groups``
    is accepted and unused, as there."""

    def __init__(self, groups=1):
        self.groups = groups

    def _fill(self, out, gen):
        shape = tuple(out.shape)
        if len(shape) not in (3, 4, 5):
            raise ValueError("Delta orthogonal initializer requires a 3D, "
                             "4D or 5D shape.")
        if shape[-1] < shape[-2]:
            raise ValueError("`fan_in` must be less or equal than "
                             "`fan_out`. ")
        out.zero_()
        centre = tuple((k - 1) // 2 for k in shape[:-2])
        out[centre] = _orthogonal(shape[-2:], gen, out.device).to(out.dtype)


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed convolution:
    weight ``[C_in, C_out, K, K]`` holds the separable triangle filter
    in every ``[i, j]``."""

    def _fill(self, out, gen):
        shape = tuple(out.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        k = shape[-1]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:k, :k]
        filt = ((1 - np.abs(og[0] / f - c))
                * (1 - np.abs(og[1] / f - c))).astype("float64")
        out.copy_(torch.from_numpy(np.broadcast_to(filt, shape).copy()))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


_GLOBAL = {"weight": None, "bias": None}


def set_global_initializer(weight_init=None, bias_init=None) -> None:
    """The initializers of weights and of biases made with none given
    (``None``: the layer's own default)."""
    _GLOBAL["weight"], _GLOBAL["bias"] = weight_init, bias_init


def global_initializer(is_bias: bool):
    return _GLOBAL["bias" if is_bias else "weight"]
