"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``),
with the JAX layers' arguments: the 1-d and 3-d max pools take no ceil
mode, ``AvgPool3D`` no ``exclusive`` (its pool counts the input's
elements only)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "AvgPool1D", "MaxPool2D", "AvgPool2D", "MaxPool3D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D"]


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.exclusive)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.return_mask, self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive, None, self.data_format)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p,
                            data_format=self.data_format)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool3d(x, self.k, self.s, self.p,
                            data_format=self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
