"""The layers the GPT model needs, with Paddle's layouts and semantics.

``Linear`` keeps Paddle's ``[in, out]`` weight, so it is a module of its
own; ``Embedding`` is ``torch.nn.Embedding`` (same ``[num, dim]``
layout); ``LayerNorm`` is ``torch.nn.LayerNorm`` (eps 1e-5) computing in
float32 whatever its input dtype, as the JAX package's does.
"""
from __future__ import annotations

import math

import torch

from . import functional
from .functional import layer_norm, linear

__all__ = ["Linear", "Embedding", "LayerNorm", "functional"]


class Linear(torch.nn.Module):
    """``y = x @ weight + bias``, ``weight [in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = torch.nn.Parameter(
            torch.empty(in_features, out_features, **kw))
        self.bias = (torch.nn.Parameter(torch.zeros(out_features, **kw))
                     if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-normal weight (Paddle's default), zero bias."""
        fan_in, fan_out = self.weight.shape
        self.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                            generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Embedding(torch.nn.Embedding):
    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-normal table (Paddle's default)."""
        num, dim = self.weight.shape
        self.weight.normal_(0.0, math.sqrt(2.0 / (num + dim)),
                            generator=generator)


class LayerNorm(torch.nn.LayerNorm):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__(normalized_shape, eps=epsilon, device=device,
                         dtype=dtype)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
