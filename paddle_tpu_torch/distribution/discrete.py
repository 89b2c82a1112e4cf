"""Discrete distributions: Categorical, Multinomial, Bernoulli.

Counterpart of ``paddle_tpu/distribution/discrete.py``: the same
formulas and the same threefry draws (Gumbel-max for the categorical
and the multinomial's counts, a uniform below ``p`` for Bernoulli).
"""
from __future__ import annotations

import torch

from .distribution import (Distribution, _arg, _categorical, _rng,
                           _shape_tuple, _uniform)

__all__ = ["Categorical", "Multinomial", "Bernoulli"]


class Categorical(Distribution):
    """Categorical over the last axis of the unnormalized ``logits``."""

    def __init__(self, logits, name=None):
        self.logits = _arg(logits)
        shp = tuple(self.logits.shape)
        super().__init__(batch_shape=shp[:-1])
        self._num_events = shp[-1]

    @property
    def probs(self):
        return torch.softmax(self.logits, -1)

    def sample(self, shape=()):
        out_shape = _shape_tuple(shape) + self._batch_shape
        logp = torch.log_softmax(self.logits, -1)
        return _categorical(_rng.next_key(), logp.detach(), out_shape)

    def log_prob(self, value):
        v = _arg(value)
        logp = torch.log_softmax(self.logits, -1)
        batch = torch.broadcast_shapes(tuple(v.shape), tuple(logp.shape[:-1]))
        idx = v.to(torch.int64).expand(batch)[..., None]
        return torch.gather(logp.expand(batch + (logp.shape[-1],)), -1,
                            idx).squeeze(-1)

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def probs_of(self, value):
        return self.prob(value)

    def entropy(self):
        logp = torch.log_softmax(self.logits, -1)
        return -torch.sum(torch.exp(logp) * logp, -1)


class Multinomial(Distribution):
    """Multinomial(total_count, probs): ``total_count`` categorical
    draws counted per category."""

    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs = _arg(probs)
        shp = tuple(self.probs.shape)
        super().__init__(batch_shape=shp[:-1], event_shape=shp[-1:])

    def _normalized(self):
        p = self.probs
        return p / p.sum(-1, keepdim=True)

    @property
    def mean(self):
        return self.total_count * self._normalized()

    @property
    def variance(self):
        q = self._normalized()
        return self.total_count * q * (1 - q)

    def sample(self, shape=()):
        out_shape = _shape_tuple(shape) + self._batch_shape
        p = self.probs.detach()
        logp = torch.log(self._normalized().detach())
        idx = _categorical(_rng.next_key(), logp,
                           (self.total_count,) + out_shape)
        onehot = torch.nn.functional.one_hot(idx, p.shape[-1]).to(p.dtype)
        return onehot.sum(0)

    def log_prob(self, value):
        v, p = _arg(value), self.probs
        logp = torch.log(self._normalized())
        logfact = torch.lgamma(torch.tensor(self.total_count + 1.0,
                                            dtype=p.dtype, device=p.device))
        return (logfact - torch.sum(torch.lgamma(v + 1.0), -1)
                + torch.sum(v * logp, -1))

    def entropy(self):
        # exact: H = -lgamma(n+1) + sum_i E[lgamma(x_i+1)] - n sum_i q_i
        # log q_i with x_i ~ Binomial(n, q_i), the expectation a sum over
        # the counts 0..n
        n = self.total_count
        q = self._normalized()
        k = torch.arange(n + 1, dtype=q.dtype, device=q.device)
        nf = torch.tensor(float(n), dtype=q.dtype, device=q.device)
        log_binom = (torch.lgamma(nf + 1) - torch.lgamma(k + 1)
                     - torch.lgamma(nf - k + 1))
        logq = torch.log(q)[..., None]
        log1mq = torch.log1p(-q)[..., None]
        log_pmf = log_binom + k * logq + (nf - k) * log1mq
        e_lgamma = torch.sum(torch.exp(log_pmf) * torch.lgamma(k + 1), -1)
        return (-torch.lgamma(nf + 1) + torch.sum(e_lgamma, -1)
                - nf * torch.sum(q * torch.log(q), -1))


class Bernoulli(Distribution):
    """Bernoulli(probs) over {0, 1}."""

    def __init__(self, probs, name=None):
        self.probs = _arg(probs)
        super().__init__(batch_shape=tuple(self.probs.shape))

    @property
    def mean(self):
        return self.probs

    @property
    def variance(self):
        return self.probs * (1 - self.probs)

    def sample(self, shape=()):
        out_shape = self._extend_shape(shape)
        p = self.probs.detach()
        u = _uniform(_rng.next_key(), out_shape, p.device)
        return (u < p).to(p.dtype)

    def log_prob(self, value):
        v = _arg(value)
        eps = 1e-7
        p = torch.clamp(self.probs, eps, 1 - eps)
        return v * torch.log(p) + (1 - v) * torch.log1p(-p)

    def entropy(self):
        eps = 1e-7
        p = torch.clamp(self.probs, eps, 1 - eps)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))
