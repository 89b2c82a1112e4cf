"""``paddle.nn`` of the port: ``Layer`` and the layers that the GPT
model and the ResNet family need, with Paddle's layouts and semantics.
"""
from __future__ import annotations

from . import functional, initializer
from .layer.activation import ReLU
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer.common import (AlphaDropout, Dropout, Dropout2D, Dropout3D,
                           Embedding, Flatten, Linear, Sequential)
from .layer.conv import Conv2D
from .layer.layers import Layer, Parameter, layer_state_from_jax
from .layer.norm import BatchNorm2D, LayerNorm
from .layer.pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Layer", "Parameter", "layer_state_from_jax", "Linear",
           "Embedding", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Flatten", "Sequential", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "Conv2D", "BatchNorm2D",
           "LayerNorm", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU",
           "functional", "initializer"]
