"""TransformedDistribution and Independent.

Counterpart of ``paddle_tpu/distribution/transformed_distribution.py``.
"""
from __future__ import annotations

from .distribution import Distribution, _arg, _sum_rightmost
from .transform import ChainTransform, Transform

__all__ = ["TransformedDistribution", "Independent"]


class TransformedDistribution(Distribution):
    def __init__(self, base, transforms):
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.base = base
        self.transforms = list(transforms)
        chain = (ChainTransform(self.transforms)
                 if len(self.transforms) != 1 else self.transforms[0])
        self._chain = chain
        base_shape = tuple(base.batch_shape) + tuple(base.event_shape)
        out_shape = chain.forward_shape(base_shape)
        event_dim = max(len(base.event_shape) + (
            chain._codomain_event_dim - chain._domain_event_dim),
            chain._codomain_event_dim)
        event_dim = min(event_dim, len(out_shape))
        super().__init__(
            batch_shape=out_shape[:len(out_shape) - event_dim],
            event_shape=out_shape[len(out_shape) - event_dim:])

    def sample(self, shape=()):
        x = self.base.sample(shape)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def rsample(self, shape=()):
        x = self.base.rsample(shape)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def log_prob(self, value):
        event_dim = len(self.event_shape)
        lp = None
        y = _arg(value)
        for t in reversed(self.transforms):
            x = t.inverse(y)
            ld = _sum_rightmost(t.forward_log_det_jacobian(x),
                                event_dim - t._codomain_event_dim)
            lp = ld if lp is None else lp + ld
            event_dim += t._domain_event_dim - t._codomain_event_dim
            y = x
        base_lp = _sum_rightmost(self.base.log_prob(y),
                                 event_dim - len(self.base.event_shape))
        return base_lp - lp if lp is not None else base_lp


class Independent(Distribution):
    """``base`` with its rightmost ``reinterpreted_batch_rank`` batch
    dims read as event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        shp = tuple(base.batch_shape)
        k = self.reinterpreted_batch_rank
        super().__init__(batch_shape=shp[:len(shp) - k],
                         event_shape=shp[len(shp) - k:]
                         + tuple(base.event_shape))

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return self.base.rsample(shape)

    def log_prob(self, value):
        return _sum_rightmost(self.base.log_prob(value),
                              self.reinterpreted_batch_rank)

    def entropy(self):
        return _sum_rightmost(self.base.entropy(),
                              self.reinterpreted_batch_rank)
