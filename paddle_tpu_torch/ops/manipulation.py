"""Shape ops with Paddle's arguments (counterpart of
``paddle_tpu/ops/manipulation.py``): ``transpose`` takes a full
permutation, ``concat``/``stack`` an ``axis``. The ops the JAX package
enters in its registry are entered under the same names."""
from __future__ import annotations

import torch

from ..core.dispatch import defop

__all__ = ["reshape", "flatten", "transpose", "concat", "stack", "squeeze",
           "unsqueeze"]


@defop("reshape")
def _reshape(x, shape=()):
    return x.reshape(shape)


def reshape(x, shape, name=None):
    return _reshape(x, shape=[int(s) for s in shape])


@defop("flatten")
def _flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis) if x.ndim else \
        x.reshape(1)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten(x, start_axis=start_axis, stop_axis=stop_axis)


@defop("transpose")
def _transpose(x, perm=()):
    return x.permute(perm)


def transpose(x, perm, name=None):
    return _transpose(x, perm=[int(p) for p in perm])


def concat(x, axis=0, name=None):
    return torch.cat(list(x), int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), int(axis))


@defop("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(a for a in axis if x.shape[a] == 1))


def squeeze(x, axis=None, name=None):
    if axis is not None and not isinstance(axis, (list, tuple)):
        axis = [axis]
    return _squeeze(x, axis=None if axis is None else [int(a) for a in axis])


@defop("unsqueeze")
def _unsqueeze(x, axis=()):
    for a in sorted(a % (x.ndim + len(axis)) for a in axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    return _unsqueeze(x, axis=[int(a) for a in axis])
