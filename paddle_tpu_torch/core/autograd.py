"""Autograd entry points: torch's engine under Paddle's names.

The JAX package records its own tape (``paddle_tpu/core/autograd.py``:
``GradNode``, ``run_backward``); the port has none, since every
``Tensor`` is a torch tensor: these are torch's grad modes and
``torch.autograd.backward`` / ``grad``.
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate into the leaves' ``.grad``."""
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, returned and not accumulated."""
    if no_grad_vars is not None:
        raise NotImplementedError("no_grad_vars is not ported")
    single = isinstance(inputs, torch.Tensor)
    out = torch.autograd.grad(outputs, [inputs] if single else list(inputs),
                              grad_outputs, retain_graph=retain_graph,
                              create_graph=create_graph,
                              allow_unused=allow_unused)
    return list(out)
