"""Reductions with Paddle's ``axis``/``keepdim`` (counterpart of
``paddle_tpu/ops/reduction.py``); ``axis=None`` reduces every axis.
Like the JAX package's, these are not entered in the op registry."""
from __future__ import annotations

import torch

__all__ = ["sum", "mean", "max", "min"]


def _axis(axis):
    if axis is None:
        return None
    return (tuple(int(a) for a in axis) if isinstance(axis, (list, tuple))
            else (int(axis),))


def sum(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return torch.sum(x, dim=_axis(axis), keepdim=keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    """The mean of an integer or bool tensor is float32, as
    ``jnp.mean``'s."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return torch.mean(x, dim=_axis(axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return torch.amax(x, dim=_axis(axis) or (), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return torch.amin(x, dim=_axis(axis) or (), keepdim=keepdim)
