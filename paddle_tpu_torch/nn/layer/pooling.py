"""``MaxPool2D`` and ``AdaptiveAvgPool2D`` (counterpart of
``paddle_tpu/nn/layer/pooling.py``)."""
from __future__ import annotations

from ..functional import adaptive_avg_pool2d, max_pool2d
from .layers import Layer

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.data_format = data_format

    def forward(self, x):
        return max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                          self.return_mask, self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, self.data_format)
