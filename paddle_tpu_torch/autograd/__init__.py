"""``paddle.autograd``: ``backward``, ``PyLayer`` and its context.

Counterpart of ``paddle_tpu/autograd/__init__.py``. ``PyLayer`` is a
``torch.autograd.Function``: a subclass writes static ``forward(ctx,
*args)`` and ``backward(ctx, *grads)`` and calls ``.apply``. Its ``ctx``
has torch's ``save_for_backward`` and ``saved_tensors`` and Paddle's
``saved_tensor``, which reads both as Paddle's method
(``ctx.saved_tensor()``) and as the JAX package's property
(``ctx.saved_tensor``).
"""
from __future__ import annotations

import torch
from torch.autograd.function import FunctionMeta

from ..core.autograd import backward, grad, no_grad

__all__ = ["backward", "grad", "no_grad", "PyLayer", "PyLayerContext"]


class _Saved(list):
    def __call__(self):
        return self


class PyLayerContext:
    """What ``PyLayer`` adds to torch's ``ctx``."""

    @property
    def saved_tensor(self):
        return _Saved(self.saved_tensors)


class _PyLayerMeta(FunctionMeta):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)
        # the class of the ctx objects torch hands to forward/backward
        cls._backward_cls = type(name + "Backward",
                                 (PyLayerContext, cls._backward_cls), {})


class PyLayer(torch.autograd.Function, metaclass=_PyLayerMeta):
    """A custom autograd function with Paddle's name."""
