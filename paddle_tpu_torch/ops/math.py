"""Elementwise math, ``cast`` and ``matmul`` (counterpart of
``paddle_tpu/ops/math.py``), registered under the JAX package's op
names."""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core.dispatch import defop

__all__ = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
           "pow", "exp", "log", "sqrt", "abs", "tanh", "cast", "matmul"]


def _binary(name, fn):
    op = defop(name)(lambda x, y: fn(x, y))

    def wrapper(x, y, name=None):
        return op(x, y)

    wrapper.__name__ = name
    return wrapper


def _unary(name, fn):
    op = defop(name)(fn)

    def wrapper(x, name=None):
        return op(x)

    wrapper.__name__ = name
    return wrapper


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
pow = _binary("elementwise_pow", torch.pow)  # noqa: A001 - Paddle's name
exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
sqrt = _unary("sqrt", torch.sqrt)
abs = _unary("abs", torch.abs)  # noqa: A001 - Paddle's name
tanh = _unary("tanh", torch.tanh)


@defop("cast")
def _cast(x, dtype=None):
    return x.to(dtype)


def cast(x, dtype):
    """``x`` in ``dtype`` (a Paddle name or a torch dtype); the gradient
    is cast back, as the JAX cast's is."""
    return _cast(x, dtype=_dt.convert_dtype(dtype))


@defop("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``; bf16/fp16 products sum in float32 on cuBLAS, as the
    JAX op asks of the MXU with ``preferred_element_type``."""
    return _matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
