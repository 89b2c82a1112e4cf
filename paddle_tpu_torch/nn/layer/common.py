"""``Linear``, ``Embedding``, the dropouts, ``Flatten``, ``Identity``,
the pads and upsamplers, ``PixelShuffle``, ``CosineSimilarity``,
``Bilinear`` and the containers ``Sequential``, ``LayerList`` and
``ParameterList`` (counterpart of ``paddle_tpu/nn/layer/common.py``).

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
from .. import functional as PF
from ..functional import (alpha_dropout, dropout, dropout2d, dropout3d,
                          linear)
from ..initializer import XavierNormal
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Sequential", "Identity", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "PixelShuffle", "CosineSimilarity",
           "Bilinear", "LayerList", "ParameterList"]


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
    package's ``jnp.where`` over the lookup. ``sparse`` is accepted and
    ignored, as in the JAX package (the gradient is dense)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None):
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


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return PF.interpolate(x, self.size, self.scale_factor, self.mode,
                              self.align_corners, self.align_mode,
                              self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        return PF.pad(x, self.padding, self.mode, self.value,
                      self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return PF.pixel_shuffle(x, self.upscale_factor, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return PF.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """``out[n, o] = x1[n] @ weight[o] @ x2[n] + bias``, weight
    ``[out, in1, in2]`` Xavier-normal, bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = (self.create_parameter([1, out_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x1, x2):
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out + self.bias if self.bias is not None else out


class LayerList(Layer):
    """Sublayers named ``"0"``, ``"1"`` ... in a list."""

    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx if idx >= 0 else len(self) + idx)]

    def __setitem__(self, idx, layer):
        self._modules[str(idx)] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, parameter):
        self.register_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx if idx >= 0 else len(self) + idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())
