"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``):
weight ``[out, in / groups, *k]`` (``[in, out / groups, *k]`` for the
transposed one) from Paddle's ``KaimingUniform(fan_in)`` (limit
``sqrt(6 / fan_in)``), bias ``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))``.

``padding_mode`` other than ``zeros`` pads the input with that mode
(``reflect``, ``replicate``, ``circular``) by the layer's padding and
convolves it unpadded, Paddle's meaning; the JAX package accepts the
argument and ignores it (ROADMAP queue C).
"""
from __future__ import annotations

import math

from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]

_LAYOUT = {1: "NCL", 2: "NCHW", 3: "NCDHW"}


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 transposed=False, output_padding=0):
        super().__init__()
        if padding_mode not in ("zeros", "reflect", "replicate", "circular"):
            raise ValueError(f"padding_mode {padding_mode!r}")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = F._ntuple(kernel_size, nd)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._padding_mode = padding_mode
        self._data_format = data_format or _LAYOUT[nd]
        self._output_padding = output_padding
        self._nd = nd
        if transposed:
            wshape = [in_channels, out_channels // groups]
        else:
            wshape = [out_channels, in_channels // groups]
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            wshape + list(self._kernel_size), attr=weight_attr,
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

    def _conv(self, fn, x):
        padding = self._padding
        if self._padding_mode != "zeros":
            x = F._first(x, self._data_format)
            pads = F._pads(padding, x.shape[2:], self._kernel_size,
                           F._ntuple(self._stride, self._nd),
                           F._ntuple(self._dilation, self._nd))
            x = F.pad(x, [0, 0, 0, 0] + [p for lo_hi in pads
                                         for p in lo_hi],
                      mode=self._padding_mode)
            x = F._back(x, self._data_format)
            padding = 0
        return fn(x, self.weight, self.bias, self._stride, padding,
                  self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv1d, x)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv2d, x)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return self._conv(F.conv3d, x)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            self._data_format, output_size)
