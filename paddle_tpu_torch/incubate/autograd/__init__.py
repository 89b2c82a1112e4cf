"""``paddle.incubate.autograd``: functional differentiation (counterpart
of ``paddle_tpu/incubate/autograd/__init__.py``).

The JAX package wraps ``jax.jvp`` / ``vjp`` / ``jacrev`` / ``hessian``.
Here the transforms are ``torch.autograd.functional``'s (``vjp`` one
``torch.autograd.grad`` after one forward), which run torch's reverse
mode (``jvp`` as the derivative of a vector-Jacobian product) and so
take every op the port differentiates, its
``autograd.Function`` kernels and the ``Tensor`` subclass included,
where ``torch.func`` refuses some of them. A function is evaluated on
its inputs' device. Its attention takes the dispatcher's route: ``vjp``
and ``Jacobian`` run the flash kernels both ways, and where ``jvp`` and
``Hessian`` differentiate a backward, the flash op's backward is the
plain composition's (``kernels/flash_attention.py``).

- ``Jacobian(func, xs)`` keeps the JAX package's unflattened shape
  (output dims, then input dims; a tuple, one per input, for several
  inputs) and ignores ``is_batched``, as the JAX class does (ROADMAP
  queue C);
- ``Hessian`` takes one input and a function of one element;
- ``forward_grad`` raises the JAX package's message; ``grad`` is
  ``paddle.grad``; the prim switches only record their state.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd import functional as AF

from ...core.autograd import grad as _eager_grad
from ...core.tensor import Tensor, to_tensor_arg

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "forward_grad", "grad",
           "enable_prim", "disable_prim", "prim_enabled"]


def _inputs(xs):
    """The inputs as a tuple of detached tensors."""
    xs = xs if isinstance(xs, (tuple, list)) else [xs]
    return tuple(to_tensor_arg(x).detach() for x in xs)


def _wrap(func):
    """``func`` over port ``Tensor``s that track gradients."""
    def fn(*args):
        out = func(*(a.as_subclass(Tensor) for a in args))
        return tuple(out) if isinstance(out, list) else out
    return fn


def _tensors(out):
    if isinstance(out, (tuple, list)):
        return tuple(o.detach().as_subclass(Tensor) for o in out)
    return out.detach().as_subclass(Tensor)


def jvp(func: Callable, xs, v=None):
    """Forward mode: ``(outputs, J v)``; ``v`` defaults to ones."""
    args = _inputs(xs)
    tangents = (tuple(torch.ones_like(a) for a in args) if v is None
                else _inputs(v))
    out, jv = AF.jvp(_wrap(func), args, tangents)
    return _tensors(out), _tensors(jv)


def vjp(func: Callable, xs, v=None):
    """Reverse mode: ``(outputs, v^T J)``, the second a tuple with one
    entry per input; ``v`` defaults to ones."""
    args = tuple(a.requires_grad_() for a in _inputs(xs))
    with torch.enable_grad():
        out = _wrap(func)(*args)
    outs = out if isinstance(out, tuple) else (out,)
    cot = (tuple(torch.ones_like(o) for o in outs) if v is None
           else _inputs(v))
    grads = torch.autograd.grad(outs, args, cot, allow_unused=True)
    return _tensors(out), _tensors([torch.zeros_like(a) if g is None else g
                                    for g, a in zip(grads, args)])


class Jacobian:
    """The full Jacobian, computed at construction; index it as an
    array."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        args = _inputs(xs)
        jac = AF.jacobian(_wrap(func), args)
        self._jac = jac if len(args) > 1 else jac[0]
        self._is_batched = is_batched

    def _first(self):
        return self._jac[0] if isinstance(self._jac, tuple) else self._jac

    @property
    def shape(self):
        return list(self._first().shape)

    def __getitem__(self, idx):
        return self._first()[idx].as_subclass(Tensor)

    def numpy(self):
        return self._first().as_subclass(Tensor).numpy()

    def as_tensors(self):
        return _tensors(self._jac)


class Hessian:
    """The Hessian of a one-element function of one input."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        args = _inputs(xs)
        if len(args) != 1:
            raise ValueError("Hessian supports a single input tensor")
        fn = _wrap(func)
        self._h = AF.hessian(lambda a: fn(a).reshape(()), args[0])

    @property
    def shape(self):
        return list(self._h.shape)

    def __getitem__(self, idx):
        return self._h[idx].as_subclass(Tensor)

    def numpy(self):
        return self._h.as_subclass(Tensor).numpy()

    def as_tensor(self):
        return _tensors(self._h)


_prim = {"enabled": False}


def enable_prim():
    _prim["enabled"] = True


def disable_prim():
    _prim["enabled"] = False


def prim_enabled() -> bool:
    return _prim["enabled"]


def forward_grad(outputs, inputs, grad_inputs=None):
    raise RuntimeError(
        "forward_grad operates on primitive static programs in the "
        "reference; use incubate.autograd.jvp(func, xs, v) — the "
        "functional forward-mode API — instead")


def grad(outputs, inputs, grad_outputs=None):
    """``paddle.grad`` (the reverse mode of an eager graph)."""
    return _eager_grad(outputs, inputs, grad_outputs)
