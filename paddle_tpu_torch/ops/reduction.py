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


def _reduce(fn, x, axis, keepdim):
    """``fn`` over ``axis``: None reduces every axis, an empty list or
    tuple none (x comes back unchanged, as ``jnp.sum(x, axis=())``
    does; torch would read ``dim=()`` as every axis)."""
    dim = _axis(axis)
    if dim == ():
        return fn(x.unsqueeze(0), dim=0)
    return fn(x, dim=() if dim is None else dim, keepdim=keepdim)


def sum(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _reduce(torch.sum, x, axis, keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    """The mean of an integer or bool tensor is float32, as
    ``jnp.mean``'s."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return _reduce(torch.mean, x, axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _reduce(torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _reduce(torch.amin, x, axis, keepdim)
