"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``).

BatchNorm keeps Paddle's momentum (0.9: ``r = 0.9 r + 0.1 batch``) and
its buffers ``_mean`` (zeros) and ``_variance`` (ones) in the default
dtype, so a JAX state dict loads under the same names; ``Layer.to``
casts them with the parameters, as the JAX package does under AMP O2.
The 1-d, 2-d and 3-d forms are one class each over the same rank-free
``batch_norm``. ``SyncBatchNorm`` on one device is ``BatchNorm`` (the
statistics of the one device's batch are the global ones).
``SpectralNorm`` carries its power iterates ``weight_u`` / ``weight_v``
as buffers; the JAX package draws their start from threefry normals,
the port from the default device's torch generator (load the JAX
buffers to match it).
"""
from __future__ import annotations

import torch

from ...core import dtypes as _dt
from ...core import random as _rng
from ...core.device import to_torch_device
from ...core.tensor import as_tensor
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
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
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm`` (any rank), with ``act``
    applied after."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout,
                         True if use_global_stats else None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class SyncBatchNorm(_BatchNormBase):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it a ``SyncBatchNorm``
        sharing its parameters and statistics."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


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
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        self.weight = (self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter([num_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    """Per (sample, channel) over the spatial axes of any rank (one class
    serves 1-d, 2-d and 3-d, as in the JAX package)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
        else:
            self.weight = self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of the weight
    viewed as ``[shape[dim], rest]``, estimated by ``power_iters`` steps
    of power iteration from the ``weight_u`` / ``weight_v`` buffers
    (in float32), which each call advances."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name=None):
        super().__init__()
        shape = [int(s) for s in weight_shape]
        if not shape or any(s <= 0 for s in shape):
            raise ValueError(f"invalid weight_shape {weight_shape}")
        if not -len(shape) <= int(dim) < len(shape):
            raise ValueError(f"dim {dim} out of range for weight_shape "
                             f"{weight_shape}")
        self._dim = int(dim) % len(shape)
        self._power_iters, self._eps = int(power_iters), float(eps)
        h = shape[self._dim]
        w = max(1, torch.Size(shape).numel() // h)
        dev = to_torch_device(None)
        gen = _rng.generator(dev)
        dt = _dt.convert_dtype(dtype)
        u = torch.randn(h, dtype=dt, device=dev, generator=gen)
        v = torch.randn(w, dtype=dt, device=dev, generator=gen)
        self.register_buffer("weight_u", as_tensor(
            u / (torch.linalg.vector_norm(u) + self._eps)))
        self.register_buffer("weight_v", as_tensor(
            v / (torch.linalg.vector_norm(v) + self._eps)))

    def forward(self, weight):
        dim, eps = self._dim, self._eps
        perm = [dim] + [i for i in range(weight.ndim) if i != dim]
        mat = weight.permute(perm).reshape(weight.shape[dim], -1).float()
        # the gradient runs through the iteration too, as JAX's vjp of
        # the whole scan does
        u, v = self.weight_u.float().clone(), self.weight_v.float().clone()
        for _ in range(self._power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ (mat @ v)
        return weight / sigma.to(weight.dtype)
