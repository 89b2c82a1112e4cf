"""The compiled train step's counterpart: ``TrainStep``.

Counterpart of ``paddle_tpu/jit/to_static.py::TrainStep``. The JAX step
traces forward, backward and the optimizer update into one XLA program
(a ``lax.scan`` of K steps with ``steps_per_call=K``); PyTorch runs
eagerly, so here a call runs the K steps in order, each ``loss_fn``,
``backward()``, ``optimizer.step()`` and ``clear_grad()``, and returns
the K losses as one device tensor. Nothing in a call reads a device
value on the host, so the host queues the K steps ahead of the device.
``scaler`` (loss scaling) and shardings are not ported.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer, steps_per_call=K)``
    then ``losses = step(x, y)``: ``loss_fn(model, x, y)`` returns the
    scalar loss. With ``K > 1`` every tensor argument has a leading
    ``[K]`` axis (step i takes index i) and the call returns the K
    losses ``[K]``; with ``K == 1`` the arguments are used as given and
    the call returns the loss."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 scaler=None, in_shardings=None, out_shardings=None,
                 steps_per_call: int = 1):
        if scaler is not None:
            raise NotImplementedError("GradScaler is not ported (queued with "
                                      "fp16)")
        if in_shardings is not None or out_shardings is not None:
            raise NotImplementedError("sharded train steps are not ported")
        self.steps_per_call = int(steps_per_call)
        if self.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def _step(self, args, kwargs):
        loss = self.loss_fn(self.model, *args, **kwargs)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()

    def __call__(self, *args, **kwargs):
        K = self.steps_per_call
        if K == 1:
            return self._step(args, kwargs)

        def at(x, i):
            return x[i] if isinstance(x, torch.Tensor) else x

        return torch.stack([
            self._step([at(a, i) for a in args],
                       {n: at(a, i) for n, a in kwargs.items()})
            for i in range(K)])
