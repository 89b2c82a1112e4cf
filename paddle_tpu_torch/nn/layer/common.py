"""``Linear``, ``Embedding``, ``Dropout``, ``Dropout2D``, ``Dropout3D``,
``AlphaDropout``, ``Flatten`` and ``Sequential`` (counterpart of
``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps Paddle's ``[in, out]`` weight. The layers take an extra
``device`` (default: the current device), which the GPT model passes;
``reset_parameters(generator)`` redraws a weight from the caller's
generator, which the GPT model uses to make its weights from a seed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...amp.auto_cast import amp_cast
from ..functional import (alpha_dropout, dropout, dropout2d, dropout3d,
                          linear)
from ..initializer import XavierNormal
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Sequential"]


def _xavier_normal_(weight, generator):
    fan_in, fan_out = weight.shape
    weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                   generator=generator)


class Linear(Layer):
    """``y = x @ weight + bias``, ``weight [in_features, out_features]``
    Xavier-normal, ``bias`` zeros (Paddle's defaults)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        self._in_features, self._out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal(), device=device)
        self.bias = (self.create_parameter([out_features], attr=bias_attr,
                                           is_bias=True, device=device)
                     if bias_attr is not False else None)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-normal weight from ``generator``, zero bias."""
        _xavier_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Embedding(Layer):
    """A lookup table ``weight [num_embeddings, embedding_dim]``,
    Xavier-normal. With ``padding_idx`` k (negative: counted from the
    end), row k starts at zero and the ids k look up exact zeros
    whatever the table holds, with no gradient to row k: the JAX
    package's ``jnp.where`` over the lookup."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_attr=None, name=None, device=None):
        super().__init__()
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal(), device=device)
        self._zero_padding_row()

    @torch.no_grad()
    def _zero_padding_row(self):
        if self._padding_idx is not None:
            self.weight[self._padding_idx] = 0

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-normal table from ``generator``, the padding row zero."""
        _xavier_normal_(self.weight, generator)
        self._zero_padding_row()

    def forward(self, x):
        weight, = amp_cast("embedding" if self._padding_idx is None
                           else "embedding_pad", self.weight)
        out = F.embedding(x, weight)
        if self._padding_idx is None:
            return out
        return torch.where((x == self._padding_idx)[..., None],
                           out.new_zeros(()), out)


class Dropout(Layer):
    """``F.dropout`` with the layer's ``training`` flag."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return dropout2d(x, self.p, training=self.training,
                         data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return dropout3d(x, self.p, training=self.training,
                         data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Sequential(Layer):
    """Sublayers run in order, named ``"0"``, ``"1"`` ... or by the
    ``(name, layer)`` pairs given."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(str(layer[0]), layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())
