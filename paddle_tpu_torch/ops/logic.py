"""Comparison and logical ops (counterpart of
``paddle_tpu/ops/logic.py``); registered under the JAX package's op
names and, as there, cut from the gradient."""
from __future__ import annotations

import torch

from ..core.dispatch import defop
from ..core.tensor import to_tensor_arg

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "isclose", "allclose", "equal_all",
           "is_empty"]


def _cmp(name, fn):
    op = defop(name, differentiable=False)(lambda x, y: fn(x, y))

    def wrapper(x, y, name=None):
        return op(x, y)

    wrapper.__name__ = name
    return wrapper


def _as(x, like):
    """A Python number as a tensor on ``like``'s device (torch's
    comparison ops take one, the bitwise and logical ones do not)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=like.device if isinstance(like, torch.Tensor) else None)


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and",
                   lambda x, y: torch.logical_and(_as(x, y), _as(y, x)))
logical_or = _cmp("logical_or",
                  lambda x, y: torch.logical_or(_as(x, y), _as(y, x)))
logical_xor = _cmp("logical_xor",
                   lambda x, y: torch.logical_xor(_as(x, y), _as(y, x)))
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)
_logical_not = defop("logical_not", differentiable=False)(torch.logical_not)
_bitwise_not = defop("bitwise_not", differentiable=False)(torch.bitwise_not)


def logical_not(x, name=None):
    return _logical_not(x)


def bitwise_not(x, name=None):
    return _bitwise_not(x)


@defop("isclose", differentiable=False)
def _isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y.to(x.dtype), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """A bool scalar tensor, on the device (no host read)."""
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y, name=None):
    x, y = to_tensor_arg(x), to_tensor_arg(y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return (x == y).all()


def is_empty(x, name=None):
    x = to_tensor_arg(x)
    return torch.tensor(x.numel() == 0, device=x.device)
