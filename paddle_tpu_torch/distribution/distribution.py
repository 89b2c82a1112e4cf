"""Distribution base classes and the draws they share.

Counterpart of ``paddle_tpu/distribution/distribution.py``. Every
density, entropy and KL is a function of torch tensors, so gradients
flow through torch's autograd; the draws take the JAX package's
threefry keys (``core/random.py`` ``next_key``, ``core/threefry.py``):
uniform, normal, Laplace, exponential, Gumbel, Bernoulli, categorical
and multinomial draws are the JAX package's on the same key (the
normal draw's ``erfinv`` is PyTorch's, which can differ from XLA's in
the last places). Gamma draws (Beta, Dirichlet) are
``torch._standard_gamma`` from the device's torch generator, with its
reparameterized gradient: the JAX package draws them from
``jax.random.gamma`` on its key, so they agree in distribution only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import random as _rng
from ..core import threefry
from ..core.tensor import to_tensor

__all__ = ["Distribution", "ExponentialFamily"]

_F32 = torch.float32


def _shape_tuple(shape) -> tuple:
    if shape is None:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _arg(x) -> torch.Tensor:
    """A distribution's argument as a tensor: tensors pass through;
    numbers, lists and arrays go to the current device, float64 and
    Python floats as float32 (the JAX package's ``to_tensor_arg`` with
    64-bit types off)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64 and not isinstance(x, np.ndarray):
        arr = arr.astype(np.int32)
    return to_tensor(arr)


def _broadcast_shapes(*tensors) -> tuple:
    return tuple(torch.broadcast_shapes(*(tuple(t.shape) for t in tensors)))


def _sample_key(seed=0):
    """An explicit seed's own key, else the global generator's next."""
    return threefry.prng_key(seed) if seed else _rng.next_key()


def _uniform(key, shape, device, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    key = key.to(device)
    bits = threefry.random_bits(key, shape)
    floats = threefry._unit_floats(bits)
    lo = torch.tensor(minval, dtype=_F32, device=device)
    hi = torch.tensor(maxval, dtype=_F32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _normal(key, shape, device):
    """``jax.random.normal``: ``sqrt(2) erfinv(u)``, u uniform on
    ``(nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = _uniform(key, shape, device, lo, 1.0)
    return torch.erfinv(u) * torch.tensor(np.float32(np.sqrt(2)),
                                          device=device)


def _gumbel(key, shape, device):
    """``jax.random.gumbel`` (float32, its default mode)."""
    return threefry.gumbel(key.to(device), shape)


def _categorical(key, logits, shape):
    """``jax.random.categorical(key, logits, shape=shape)`` over the
    last axis: Gumbel noise of ``shape + (K,)`` added, then argmax."""
    noise = _gumbel(key, tuple(shape) + (logits.shape[-1],), logits.device)
    return torch.argmax(noise + logits, dim=-1)


def _gamma(alpha, shape):
    """Standard gamma draws of concentration ``alpha`` broadcast to
    ``shape``, from the device's torch generator, reparameterized."""
    a = alpha.to(torch.promote_types(alpha.dtype, _F32)).expand(shape)
    return torch._standard_gamma(a.contiguous(),
                                 generator=_rng.generator(a.device))


def _sum_rightmost(t, n):
    if n <= 0:
        return t
    return t.sum(dim=tuple(range(-n, 0)))


def _with_grad(ts):
    """Tensors that track a gradient, for ``autograd.grad``: those that
    do already stay as they are (so their graph continues), the others
    become leaves that do."""
    return [t if t.requires_grad else t.detach().requires_grad_(True)
            for t in ts]


class Distribution:
    """Base class: ``batch_shape`` is the shape of the parameters'
    broadcast, ``event_shape`` the shape of one draw."""

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = _shape_tuple(batch_shape)
        self._event_shape = _shape_tuple(event_shape)

    @property
    def batch_shape(self):
        return list(self._batch_shape)

    @property
    def event_shape(self):
        return list(self._event_shape)

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        from .kl import kl_divergence

        return kl_divergence(self, other)

    def _extend_shape(self, sample_shape):
        return (_shape_tuple(sample_shape) + self._batch_shape
                + self._event_shape)

    @staticmethod
    def _probs_to_logits(probs, is_binary=False):
        eps = 1e-7
        p = torch.clamp(probs, eps, 1.0 - eps if is_binary else 1.0)
        return torch.log(p / (1 - p)) if is_binary else torch.log(p)

    @staticmethod
    def _logits_to_probs(logits, is_binary=False):
        return (torch.sigmoid(logits) if is_binary
                else torch.softmax(logits, -1))


class ExponentialFamily(Distribution):
    """Exponential-family base: members give their natural parameters
    and log-normalizer; the generic entropy is the Bregman identity
    H = A(t) - <t, grad A(t)> + E[log h(x)], the gradient by autograd."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        raise NotImplementedError

    def _entropy_bregman(self):
        params = list(self._natural_parameters)
        with torch.enable_grad():
            nat = _with_grad(params)
            ent = self._log_normalizer(*nat)
            grads = torch.autograd.grad(ent.sum(), nat, create_graph=True)
            for n, g in zip(nat, grads):
                term = n * g
                # reduce the event dims the log normalizer reduced
                extra = term.dim() - ent.dim()
                if extra > 0:
                    term = term.sum(dim=tuple(range(-extra, 0)))
                ent = ent - term
        if not any(p.requires_grad for p in params):
            ent = ent.detach()
        return ent + self._mean_carrier_measure
