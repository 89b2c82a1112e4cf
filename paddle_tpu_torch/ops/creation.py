"""Creation ops (counterpart of ``paddle_tpu/ops/creation.py`` and the
draws of ``ops/random_ops.py``): each returns a leaf ``Tensor`` on the
current device; random draws come from that device's generator."""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core import random as _rng
from ..core.device import current_device
from ..core.tensor import as_tensor, to_tensor

__all__ = ["to_tensor", "zeros", "ones", "full", "arange", "rand", "randn",
           "randint"]


def _shape(shape):
    return [int(s) for s in shape] if isinstance(shape, (list, tuple)) \
        else [int(shape)]


def _dtype(dtype):
    return _dt.convert_dtype(dtype) or _dt.get_default_dtype()


def full(shape, fill_value, dtype=None, name=None):
    """Without ``dtype``, the fill value's type picks it, as in the JAX
    package: bool gives bool, int gives int64 (the port's integer
    default), anything else the default float dtype."""
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        dtype = (_dt.bool_ if isinstance(fill_value, bool)
                 else _dt.int64 if isinstance(fill_value, int)
                 else _dt.get_default_dtype())
    return as_tensor(torch.full(_shape(shape), fill_value,
                                dtype=_dtype(dtype), device=current_device()))


def zeros(shape, dtype=None, name=None):
    return full(shape, 0, _dtype(dtype))


def ones(shape, dtype=None, name=None):
    return full(shape, 1, _dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """Integers (int64) when every bound is an int, else the default
    float dtype, as in the JAX package."""
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (_dt.int64 if all(isinstance(v, int)
                                  for v in (start, end, step))
                 else _dt.get_default_dtype())
    return as_tensor(torch.arange(start, end, step,
                                  dtype=_dt.convert_dtype(dtype),
                                  device=current_device()))


def rand(shape, dtype=None, name=None):
    dev = current_device()
    return as_tensor(torch.rand(_shape(shape), dtype=_dtype(dtype),
                                device=dev, generator=_rng.generator(dev)))


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return as_tensor(torch.randn(_shape(shape), dtype=_dtype(dtype),
                                 device=dev, generator=_rng.generator(dev)))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return as_tensor(torch.randint(low, high, _shape(shape),
                                   dtype=_dt.convert_dtype(dtype), device=dev,
                                   generator=_rng.generator(dev)))
