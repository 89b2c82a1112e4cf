"""The op registry.

Counterpart of ``paddle_tpu/core/dispatch.py``: ops registered under a
name (``register_op``, ``defop``), looked up with ``get_op`` and listed
with ``list_ops``. The JAX registry's ``apply`` traces each op's vjp
onto its tape; here an op *is* its plain function on torch tensors, and
torch differentiates it as it runs. A non-differentiable op runs under
``no_grad``, so its outputs stop the gradient as the JAX op's do.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch

from .tensor import to_tensor_arg

__all__ = ["Op", "register_op", "get_op", "list_ops", "defop"]

_REGISTRY: Dict[str, "Op"] = {}


class Op:
    __slots__ = ("name", "fn", "differentiable")

    def __init__(self, name: str, fn: Callable, differentiable: bool = True):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable

    def __call__(self, *args, **kwargs):
        if self.differentiable:
            return self.fn(*args, **kwargs)
        with torch.no_grad():
            return self.fn(*args, **kwargs)

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
