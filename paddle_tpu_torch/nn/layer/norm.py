"""``BatchNorm2D`` and ``LayerNorm`` (counterpart of
``paddle_tpu/nn/layer/norm.py``).

BatchNorm keeps Paddle's momentum (0.9: ``r = 0.9 r + 0.1 batch``) and
its buffers ``_mean`` (zeros) and ``_variance`` (ones) in the default
dtype, so a JAX state dict loads under the same names; ``Layer.to``
casts them with the parameters, as the JAX package does under AMP O2.
"""
from __future__ import annotations

import torch

from ...core import dtypes as _dt
from ...core.device import to_torch_device
from ...core.tensor import as_tensor
from ..functional import batch_norm, layer_norm
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm2D", "LayerNorm"]


class BatchNorm2D(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([num_features], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)
        kw = dict(dtype=_dt.get_default_dtype(), device=to_torch_device(None))
        self.register_buffer("_mean", as_tensor(torch.zeros(num_features,
                                                            **kw)))
        self.register_buffer("_variance", as_tensor(torch.ones(num_features,
                                                               **kw)))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class LayerNorm(Layer):
    """LayerNorm over the last ``len(normalized_shape)`` axes (an int is
    one axis; eps 1e-5), computed in float32 whatever the input dtype, as
    the JAX package's is. ``weight_attr=False`` / ``bias_attr=False``
    create no weight / bias (``None``)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = [int(n) for n in normalized_shape]
        self._epsilon = epsilon
        self.weight = (self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0), device=device)
            if weight_attr is not False else None)
        self.bias = (self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            device=device) if bias_attr is not False else None)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)
