"""The op registry.

Counterpart of ``paddle_tpu/core/dispatch.py``: ops registered under a
name (``register_op``, ``defop``), looked up with ``get_op`` and listed
with ``list_ops``. The JAX registry's ``apply`` traces each op's vjp
onto its tape; here an op *is* its plain function on torch tensors, and
torch differentiates it as it runs. A non-differentiable op runs under
``no_grad``, so its outputs stop the gradient as the JAX op's do. With
``FLAGS_check_nan_inf`` set, every op checks its floating outputs (the
JAX dispatcher's ``_maybe_check_nan_inf``; the ``Tensor`` hook checks
every torch call on a ``Tensor`` too).

:func:`recordable` marks a function that the static recorder
(``paddle_tpu_torch.static``) must record as one op, with its output
shapes from an ``infer`` function, rather than trace through: a
``torch.autograd.Function`` with its own backward, or a kernel that
reads raw pointers. Called on concrete tensors it is the function
itself.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch

from .tensor import CHECK_NAN_INF, check_finite, to_tensor_arg

__all__ = ["Op", "register_op", "get_op", "list_ops", "defop",
           "recordable", "set_recorder", "is_symbolic"]

_REGISTRY: Dict[str, "Op"] = {}


class Op:
    __slots__ = ("name", "fn", "differentiable")

    def __init__(self, name: str, fn: Callable, differentiable: bool = True):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable

    def __call__(self, *args, **kwargs):
        if self.differentiable:
            out = self.fn(*args, **kwargs)
        else:
            with torch.no_grad():
                out = self.fn(*args, **kwargs)
        if CHECK_NAN_INF[0]:
            check_finite(self.name, out)
        return out

    def __repr__(self):
        return f"Op<{self.name}>"


def register_op(name: str, fn: Callable, differentiable: bool = True) -> Op:
    """Register ``fn`` as the op ``name`` (a later registration of the
    same name replaces it, as in the JAX registry)."""
    op = Op(name, fn, differentiable)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> Op:
    return _REGISTRY[name]


def list_ops() -> List[str]:
    return sorted(_REGISTRY)


def defop(name: str, differentiable: bool = True):
    """Decorator: register a function on tensors as the op ``name``.
    Positional arguments are tensors (arrays and lists are converted),
    keyword arguments static, as in the JAX ``defop``. The wrapper
    carries the op as ``.op``."""

    def deco(fn):
        op = register_op(name, fn, differentiable)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return op(*(to_tensor_arg(a) for a in args), **kwargs)

        wrapper.op = op
        return wrapper

    return deco


# the static recorder's hook, ``(name, fn, args, kwargs, infer) -> out``
# (set by ``paddle_tpu_torch.static.program`` when it is imported)
_RECORDER: List[Callable] = []


def set_recorder(hook: Callable) -> None:
    _RECORDER[:] = [hook]


def is_symbolic(x) -> bool:
    """A static-graph ``Variable`` (a tensor the recorder tracks)."""
    return getattr(type(x), "_symbolic", False)


def recordable(name: str, infer: Callable):
    """Decorator: on symbolic inputs, record ``fn`` as the one op
    ``name`` whose outputs ``infer(*args, **kwargs)`` shapes (on fake
    tensors); otherwise call ``fn``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _RECORDER and (any(is_symbolic(a) for a in args)
                              or any(is_symbolic(a)
                                     for a in kwargs.values())):
                return _RECORDER[0](name, fn, args, kwargs, infer)
            return fn(*args, **kwargs)

        return wrapper

    return deco
