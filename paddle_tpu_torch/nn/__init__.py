"""``paddle.nn`` of the port: ``Layer`` and the layers that the GPT
model, the ResNet family and LeNet need, and the loss layers, with
Paddle's layouts and semantics.
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
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                         KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
                         NLLLoss, SmoothL1Loss)
from .layer.norm import BatchNorm2D, LayerNorm
from .layer.pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Layer", "Parameter", "layer_state_from_jax", "Linear",
           "Embedding", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Flatten", "Sequential", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "Conv2D", "BatchNorm2D",
           "LayerNorm", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "MarginRankingLoss",
           "functional", "initializer"]
