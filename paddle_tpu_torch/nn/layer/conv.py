"""``Conv2D`` (counterpart of ``paddle_tpu/nn/layer/conv.py``): weight
``[out, in / groups, kh, kw]`` from Paddle's ``KaimingUniform(fan_in)``
(limit ``sqrt(6 / fan_in)``), bias ``Uniform(-1/sqrt(fan_in),
1/sqrt(fan_in))``."""
from __future__ import annotations

import math

from ..functional import conv2d
from ..initializer import KaimingUniform, Uniform
from .layers import Layer

__all__ = ["Conv2D"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r} is "
                                      "not ported")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr,
            default_initializer=(KaimingUniform(fan_in=fan_in)
                                 if weight_attr is None else None))
        if bias_attr is not False:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True,
                default_initializer=(Uniform(-bound, bound)
                                     if bias_attr is None else None))
        else:
            self.bias = None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}")
