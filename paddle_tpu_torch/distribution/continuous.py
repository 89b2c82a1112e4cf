"""Continuous distributions: Normal, LogNormal, Uniform, Laplace,
Gumbel, Beta, Dirichlet, Exponential.

Counterpart of ``paddle_tpu/distribution/continuous.py``: the same
formulas, the same threefry draws (gamma draws aside: see
``distribution.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .distribution import (ExponentialFamily, Distribution, _arg,
                           _broadcast_shapes, _gamma, _gumbel, _normal,
                           _rng, _sample_key, _shape_tuple, _uniform)

__all__ = ["Normal", "LogNormal", "Uniform", "Laplace", "Gumbel", "Beta",
           "Dirichlet", "Exponential"]


def _bcast(t, *others):
    return torch.broadcast_to(t, _broadcast_shapes(*others))


def _key_or_next(key):
    return key if key is not None else _rng.next_key()


class Normal(ExponentialFamily):
    """N(loc, scale)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _arg(loc)
        self.scale = _arg(scale)
        super().__init__(batch_shape=_broadcast_shapes(self.loc, self.scale))

    @property
    def mean(self):
        return _bcast(self.loc, self.loc, self.scale)

    @property
    def variance(self):
        return _bcast(self.scale * self.scale, self.loc, self.scale)

    @property
    def stddev(self):
        return _bcast(self.scale, self.loc, self.scale)

    def rsample(self, shape=(), _key=None):
        out_shape = self._extend_shape(shape)
        z = _normal(_key_or_next(_key), out_shape, self.loc.device)
        return self.loc + self.scale * z

    def sample(self, shape=(), seed=0):
        return self.rsample(shape, _key=_sample_key(seed) if seed
                            else None).detach()

    def log_prob(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return (-((v - l) ** 2) / (2 * s * s) - torch.log(s)
                - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return _bcast(0.5 + 0.5 * math.log(2 * math.pi)
                      + torch.log(self.scale), self.loc, self.scale)

    def cdf(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return 0.5 * (1 + torch.erf((v - l) / (s * math.sqrt(2.0))))

    def icdf(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return l + s * math.sqrt(2.0) * torch.erfinv(2 * v - 1)

    def probs(self, value):
        return self.prob(value)

    @property
    def _natural_parameters(self):
        l, s = self.loc, self.scale
        return (l / (s * s), -0.5 / (s * s))

    def _log_normalizer(self, x, y):
        return -0.25 * x * x / y + 0.5 * torch.log(-math.pi / y)

    @property
    def _mean_carrier_measure(self):
        return 0.0


class LogNormal(ExponentialFamily):
    """exp(N(loc, scale))."""

    def __init__(self, loc, scale, name=None):
        self.loc = _arg(loc)
        self.scale = _arg(scale)
        self._base = Normal(self.loc, self.scale)
        super().__init__(batch_shape=_broadcast_shapes(self.loc, self.scale))

    @property
    def mean(self):
        return torch.exp(self.loc + self.scale * self.scale / 2)

    @property
    def variance(self):
        l, s = self.loc, self.scale
        return (torch.exp(s * s) - 1) * torch.exp(2 * l + s * s)

    def rsample(self, shape=(), _key=None):
        return torch.exp(self._base.rsample(shape, _key=_key))

    def sample(self, shape=(), seed=0):
        return self.rsample(shape, _key=_sample_key(seed) if seed
                            else None).detach()

    def log_prob(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return (-((torch.log(v) - l) ** 2) / (2 * s * s) - torch.log(s * v)
                - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        l, s = self.loc, self.scale
        return _bcast(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(s) + l,
                      l, s)


class Uniform(Distribution):
    """U[low, high)."""

    def __init__(self, low, high, name=None):
        self.low = _arg(low)
        self.high = _arg(high)
        super().__init__(batch_shape=_broadcast_shapes(self.low, self.high))

    @property
    def mean(self):
        return (self.low + self.high) / 2

    @property
    def variance(self):
        return (self.high - self.low) ** 2 / 12

    def rsample(self, shape=(), _key=None):
        out_shape = self._extend_shape(shape)
        u = _uniform(_key_or_next(_key), out_shape, self.low.device)
        return self.low + (self.high - self.low) * u

    def sample(self, shape=(), seed=0):
        return self.rsample(shape, _key=_sample_key(seed) if seed
                            else None).detach()

    def log_prob(self, value):
        v, a, b = _arg(value), self.low, self.high
        lp = -torch.log(b - a)
        return torch.where((v >= a) & (v < b), lp,
                           torch.full_like(lp, float("-inf")))

    def entropy(self):
        return torch.log(self.high - self.low)


class Laplace(Distribution):
    """Laplace(loc, scale)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _arg(loc)
        self.scale = _arg(scale)
        super().__init__(batch_shape=_broadcast_shapes(self.loc, self.scale))

    @property
    def mean(self):
        return _bcast(self.loc, self.loc, self.scale)

    @property
    def variance(self):
        return _bcast(2 * self.scale * self.scale, self.loc, self.scale)

    @property
    def stddev(self):
        return _bcast(math.sqrt(2.0) * self.scale, self.loc, self.scale)

    def rsample(self, shape=(), _key=None):
        out_shape = self._extend_shape(shape)
        eps = np.finfo(np.float32).eps
        u = _uniform(_key_or_next(_key), out_shape, self.loc.device,
                     float(np.float32(-1) + eps), 1.0)
        return self.loc - self.scale * torch.sign(u) * torch.log1p(
            -torch.abs(u))

    def sample(self, shape=(), seed=0):
        return self.rsample(shape, _key=_sample_key(seed) if seed
                            else None).detach()

    def log_prob(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return -torch.abs(v - l) / s - torch.log(2 * s)

    def entropy(self):
        return _bcast(1 + torch.log(2 * self.scale), self.loc, self.scale)

    def cdf(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return 0.5 - 0.5 * torch.sign(v - l) * torch.expm1(
            -torch.abs(v - l) / s)

    def icdf(self, value):
        p, l, s = _arg(value), self.loc, self.scale
        return l - s * torch.sign(p - 0.5) * torch.log1p(
            -2 * torch.abs(p - 0.5))


class Gumbel(Distribution):
    """Gumbel(loc, scale)."""

    _EULER = 0.57721566490153286060

    def __init__(self, loc, scale, name=None):
        self.loc = _arg(loc)
        self.scale = _arg(scale)
        super().__init__(batch_shape=_broadcast_shapes(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc + self._EULER * self.scale

    @property
    def variance(self):
        return _bcast((math.pi ** 2 / 6) * self.scale * self.scale,
                      self.loc, self.scale)

    @property
    def stddev(self):
        return _bcast((math.pi / math.sqrt(6)) * self.scale, self.loc,
                      self.scale)

    def rsample(self, shape=(), _key=None):
        out_shape = self._extend_shape(shape)
        g = _gumbel(_key_or_next(_key), out_shape, self.loc.device)
        return self.loc + self.scale * g

    def sample(self, shape=(), seed=0):
        return self.rsample(shape, _key=_sample_key(seed) if seed
                            else None).detach()

    def log_prob(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        z = (v - l) / s
        return -(z + torch.exp(-z)) - torch.log(s)

    def entropy(self):
        return _bcast(torch.log(self.scale) + 1 + self._EULER, self.loc,
                      self.scale)

    def cdf(self, value):
        v, l, s = _arg(value), self.loc, self.scale
        return torch.exp(-torch.exp(-(v - l) / s))


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(ExponentialFamily):
    """Beta(alpha, beta), drawn as two gamma draws."""

    def __init__(self, alpha, beta, name=None):
        self.alpha = _arg(alpha)
        self.beta = _arg(beta)
        super().__init__(batch_shape=_broadcast_shapes(self.alpha, self.beta))

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    @property
    def variance(self):
        a, b = self.alpha, self.beta
        return a * b / ((a + b) ** 2 * (a + b + 1))

    def rsample(self, shape=()):
        out_shape = self._extend_shape(shape)
        ga = _gamma(self.alpha, out_shape)
        gb = _gamma(self.beta, out_shape)
        return ga / (ga + gb)

    def sample(self, shape=()):
        return self.rsample(shape).detach()

    def log_prob(self, value):
        v, a, b = _arg(value), self.alpha, self.beta
        return ((a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
                - _lbeta(a, b))

    def entropy(self):
        a, b = self.alpha, self.beta
        dg = torch.digamma
        return (_lbeta(a, b) - (a - 1) * dg(a) - (b - 1) * dg(b)
                + (a + b - 2) * dg(a + b))


class Dirichlet(ExponentialFamily):
    """Dirichlet(concentration) over the last axis."""

    def __init__(self, concentration, name=None):
        self.concentration = _arg(concentration)
        shp = tuple(self.concentration.shape)
        super().__init__(batch_shape=shp[:-1], event_shape=shp[-1:])

    @property
    def mean(self):
        c = self.concentration
        return c / c.sum(-1, keepdim=True)

    @property
    def variance(self):
        c = self.concentration
        c0 = c.sum(-1, keepdim=True)
        m = c / c0
        return m * (1 - m) / (c0 + 1)

    def rsample(self, shape=()):
        out_shape = _shape_tuple(shape) + tuple(self.concentration.shape)
        g = _gamma(self.concentration, out_shape)
        return g / g.sum(-1, keepdim=True)

    def sample(self, shape=()):
        return self.rsample(shape).detach()

    def log_prob(self, value):
        v, c = _arg(value), self.concentration
        ln_b = torch.sum(torch.lgamma(c), -1) - torch.lgamma(c.sum(-1))
        return torch.sum((c - 1) * torch.log(v), -1) - ln_b

    def entropy(self):
        c = self.concentration
        k = c.shape[-1]
        c0 = c.sum(-1)
        ln_b = torch.sum(torch.lgamma(c), -1) - torch.lgamma(c0)
        dg = torch.digamma
        return ln_b + (c0 - k) * dg(c0) - torch.sum((c - 1) * dg(c), -1)


class Exponential(ExponentialFamily):
    """Exponential(rate)."""

    def __init__(self, rate, name=None):
        self.rate = _arg(rate)
        super().__init__(batch_shape=tuple(self.rate.shape))

    @property
    def mean(self):
        return 1.0 / self.rate

    @property
    def variance(self):
        return 1.0 / (self.rate * self.rate)

    def rsample(self, shape=()):
        out_shape = self._extend_shape(shape)
        u = _uniform(_rng.next_key(), out_shape, self.rate.device)
        return -torch.log1p(-u) / self.rate

    def sample(self, shape=()):
        return self.rsample(shape).detach()

    def log_prob(self, value):
        v, r = _arg(value), self.rate
        return torch.log(r) - r * v

    def entropy(self):
        return 1 - torch.log(self.rate)

    def cdf(self, value):
        v, r = _arg(value), self.rate
        return -torch.expm1(-r * v)
