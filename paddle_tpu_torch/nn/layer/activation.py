"""``ReLU`` (counterpart of ``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from ..functional import relu
from .layers import Layer

__all__ = ["ReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
