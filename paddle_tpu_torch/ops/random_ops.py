"""Random sampling ops (counterpart of ``paddle_tpu/ops/random_ops.py``).

The JAX package draws from threefry keys; here every op draws from the
current device's torch generator (``core.random.generator``, reseeded
by ``paddle.seed``), on the device: the same distributions, shapes and
dtypes, other numbers (ROADMAP queue C, the two randomness streams).
Dropout and ``generate`` keep the threefry stream (``core/random.py``).
"""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core import random as _rng
from ..core.device import current_device
from ..core.tensor import as_tensor, to_tensor_arg

__all__ = ["uniform", "rand", "normal", "randn", "standard_normal",
           "randint", "randint_like", "randperm", "bernoulli", "poisson",
           "multinomial", "exponential_", "uniform_", "normal_"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return [int(s) for s in shape] if isinstance(shape, (list, tuple)) \
        else [int(shape)]


def _gen(device, seed=0):
    """The device's generator, or a fresh one from ``seed`` (non-zero)."""
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _rng.generator(device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None):
    dev = current_device()
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    out = torch.empty(_shape(shape), dtype=dtype, device=dev)
    return as_tensor(out.uniform_(float(min), float(max),
                                  generator=_gen(dev, seed)))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return as_tensor(torch.randn(
        _shape(shape), dtype=_dt.convert_dtype(dtype) or
        _dt.get_default_dtype(), device=dev, generator=_rng.generator(dev)))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """``mean + std * noise``; tensor means or stds broadcast to the
    noise's shape (their broadcast shape), scalars take ``shape``."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = to_tensor_arg(mean), to_tensor_arg(std)
        shp = torch.broadcast_shapes(torch.as_tensor(m).shape,
                                     torch.as_tensor(s).shape)
        return m + s * randn(list(shp))
    return mean + std * randn(shape)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return as_tensor(torch.randint(int(low), int(high), _shape(shape),
                                   dtype=_dt.convert_dtype(dtype), device=dev,
                                   generator=_rng.generator(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = to_tensor_arg(x)
    return randint(low, high, list(x.shape), dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return as_tensor(torch.randperm(int(n), dtype=_dt.convert_dtype(dtype),
                                    device=dev,
                                    generator=_rng.generator(dev)))


def bernoulli(x, name=None):
    """0/1 draws with probabilities x, in x's dtype, on x's device."""
    x = to_tensor_arg(x)
    return torch.bernoulli(x.detach(), generator=_rng.generator(x.device))


def poisson(x, name=None):
    x = to_tensor_arg(x)
    return torch.poisson(x.detach(), generator=_rng.generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 category draws from the rows of x (weights, normalised)."""
    x = to_tensor_arg(x)
    return torch.multinomial(x.detach().float(), int(num_samples),
                             replacement=replacement,
                             generator=_rng.generator(x.device))


@torch.no_grad()
def exponential_(x, lam=1.0, name=None):
    return x.exponential_(lam, generator=_rng.generator(x.device))


@torch.no_grad()
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    return x.uniform_(float(min), float(max), generator=_gen(x.device, seed))


@torch.no_grad()
def normal_(x, mean=0.0, std=1.0, name=None):
    return x.normal_(float(mean), float(std),
                     generator=_rng.generator(x.device))
