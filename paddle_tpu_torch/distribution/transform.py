"""Bijective transforms: Abs, Affine, Chain, Exp, Independent, Power,
Reshape, Sigmoid, Softmax, Stack, StickBreaking, Tanh.

Counterpart of ``paddle_tpu/distribution/transform.py``: each a forward
and inverse function and ``log |det J|``, so a transformed
distribution's ``log_prob`` is differentiable.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .distribution import _arg, _sum_rightmost

__all__ = ["Type", "Transform", "AbsTransform", "AffineTransform",
           "ChainTransform", "ExpTransform", "IndependentTransform",
           "PowerTransform", "ReshapeTransform", "SigmoidTransform",
           "SoftmaxTransform", "StackTransform", "StickBreakingTransform",
           "TanhTransform"]


def _softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Type:
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"


class Transform:
    _type = Type.INJECTION
    # event dims consumed and produced (0: elementwise)
    _domain_event_dim = 0
    _codomain_event_dim = 0

    def _is_injective(self):
        return self._type in (Type.BIJECTION, Type.INJECTION)

    def __call__(self, x):
        return self.forward(x)

    def forward(self, x):
        return self._forward(_arg(x))

    def inverse(self, y):
        return self._inverse(_arg(y))

    def forward_log_det_jacobian(self, x):
        return self._forward_log_det_jacobian(_arg(x))

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)


class AbsTransform(Transform):
    _type = Type.SURJECTION

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y  # the principal branch

    def _forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)


class AffineTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, loc, scale):
        self.loc = _arg(loc)
        self.scale = _arg(scale)

    def forward(self, x):
        return self.loc + self.scale * _arg(x)

    def inverse(self, y):
        return (_arg(y) - self.loc) / self.scale

    def forward_log_det_jacobian(self, x):
        x = _arg(x)
        return torch.broadcast_to(
            torch.log(torch.abs(self.scale)),
            torch.broadcast_shapes(x.shape, self.scale.shape))

    def inverse_log_det_jacobian(self, y):
        y = _arg(y)
        return torch.broadcast_to(
            -torch.log(torch.abs(self.scale)),
            torch.broadcast_shapes(y.shape, self.scale.shape))


class ExpTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, power):
        self.power = _arg(power)

    def forward(self, x):
        return torch.pow(_arg(x), self.power)

    def inverse(self, y):
        return torch.pow(_arg(y), 1.0 / self.power)

    def forward_log_det_jacobian(self, x):
        x, p = _arg(x), self.power
        return torch.log(torch.abs(p * torch.pow(x, p - 1)))


class SigmoidTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        return -_softplus(-x) - _softplus(x)


class TanhTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x)), stable
        return 2.0 * (math.log(2.0) - x - _softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    _type = Type.OTHER
    _domain_event_dim = 1
    _codomain_event_dim = 1

    def _forward(self, x):
        return torch.softmax(x, -1)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        raise NotImplementedError("SoftmaxTransform is not injective")


def _offsets(n: int, start: int, like):
    return torch.arange(start, n + start, dtype=like.dtype, device=like.device)


class StickBreakingTransform(Transform):
    _type = Type.BIJECTION
    _domain_event_dim = 1
    _codomain_event_dim = 1

    def _forward(self, x):
        k = x.shape[-1]
        offset = (k + 1) - _offsets(k, 1, x)
        z = torch.sigmoid(x - torch.log(offset))
        ones = torch.ones(z.shape[:-1] + (1,), dtype=z.dtype, device=z.device)
        zpad = torch.cat([z, ones], -1)
        one_minus = torch.cat([ones, torch.cumprod(1 - z, -1)], -1)
        return zpad * one_minus

    def _inverse(self, y):
        y_crop = y[..., :-1]
        offset = y.shape[-1] - _offsets(y.shape[-1] - 1, 1, y)
        sf = 1 - torch.cumsum(y_crop, -1)
        ones = torch.ones(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
        sf_shifted = torch.cat([ones, sf[..., :-1]], -1)
        z = y_crop / sf_shifted
        return torch.log(z / (1 - z)) + torch.log(offset)

    def _forward_log_det_jacobian(self, x):
        k = x.shape[-1]
        offset = (k + 1) - _offsets(k, 1, x)
        z = torch.sigmoid(x - torch.log(offset))
        ones = torch.ones(z.shape[:-1] + (1,), dtype=z.dtype, device=z.device)
        one_minus = torch.cat([ones, torch.cumprod(1 - z, -1)[..., :-1]], -1)
        # reduced over the event axis
        return torch.sum(torch.log(z) + torch.log1p(-z)
                         + torch.log(one_minus), -1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class ReshapeTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)
        if int(np.prod(self.in_event_shape)) != int(
                np.prod(self.out_event_shape)):
            raise ValueError("in/out event sizes must match")
        self._domain_event_dim = len(self.in_event_shape)
        self._codomain_event_dim = len(self.out_event_shape)

    def _forward(self, x):
        batch = tuple(x.shape[:x.dim() - len(self.in_event_shape)])
        return x.reshape(batch + self.out_event_shape)

    def _inverse(self, y):
        batch = tuple(y.shape[:y.dim() - len(self.out_event_shape)])
        return y.reshape(batch + self.in_event_shape)

    def _forward_log_det_jacobian(self, x):
        batch = tuple(x.shape[:x.dim() - len(self.in_event_shape)])
        return torch.zeros(batch, dtype=x.dtype, device=x.device)

    def forward_shape(self, shape):
        n = len(self.in_event_shape)
        return tuple(shape[:len(shape) - n]) + self.out_event_shape

    def inverse_shape(self, shape):
        n = len(self.out_event_shape)
        return tuple(shape[:len(shape) - n]) + self.in_event_shape


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)
        # injective when every member is
        if all(t._type == Type.BIJECTION for t in self.transforms):
            self._type = Type.BIJECTION
        elif all(t._is_injective() for t in self.transforms):
            self._type = Type.INJECTION
        else:
            self._type = Type.OTHER
        # the event dims the chain consumes and produces, folded through
        # the composition in both directions
        d = 0
        for t in reversed(self.transforms):
            d = max(t._domain_event_dim,
                    d + t._domain_event_dim - t._codomain_event_dim)
        self._domain_event_dim = d
        c = 0
        for t in self.transforms:
            c = max(t._codomain_event_dim,
                    c + t._codomain_event_dim - t._domain_event_dim)
        self._codomain_event_dim = c

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = None
        event_dim = self._domain_event_dim
        for t in self.transforms:
            ld = _sum_rightmost(t.forward_log_det_jacobian(x),
                                event_dim - t._domain_event_dim)
            total = ld if total is None else total + ld
            x = t.forward(x)
            event_dim += t._codomain_event_dim - t._domain_event_dim
        return total

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return shape

    def inverse_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.inverse_shape(shape)
        return shape


class IndependentTransform(Transform):
    """The base transform with the rightmost ``reinterpreted_batch_rank``
    dims of its log-det summed as event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        self._type = base._type
        self._domain_event_dim = (base._domain_event_dim
                                  + self.reinterpreted_batch_rank)
        self._codomain_event_dim = (base._codomain_event_dim
                                    + self.reinterpreted_batch_rank)

    def forward(self, x):
        return self.base.forward(x)

    def inverse(self, y):
        return self.base.inverse(y)

    def forward_log_det_jacobian(self, x):
        return _sum_rightmost(self.base.forward_log_det_jacobian(x),
                              self.reinterpreted_batch_rank)

    def forward_shape(self, shape):
        return self.base.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base.inverse_shape(shape)


class StackTransform(Transform):
    """A transform per slice of ``axis``."""

    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = int(axis)

    def _map(self, x, method):
        parts = torch.unbind(_arg(x), self.axis)
        if len(parts) != len(self.transforms):
            raise ValueError(
                f"StackTransform has {len(self.transforms)} transforms but "
                f"axis {self.axis} has {len(parts)} slices")
        return torch.stack([getattr(t, method)(p)
                            for t, p in zip(self.transforms, parts)],
                           self.axis)

    def forward(self, x):
        return self._map(x, "forward")

    def inverse(self, y):
        return self._map(y, "inverse")

    def forward_log_det_jacobian(self, x):
        return self._map(x, "forward_log_det_jacobian")
