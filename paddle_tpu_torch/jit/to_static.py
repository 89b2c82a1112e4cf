"""The compiled train step's counterpart: ``TrainStep``.

Counterpart of ``paddle_tpu/jit/to_static.py::TrainStep``. The JAX step
traces forward, backward and the optimizer update into one XLA program
(a ``lax.scan`` of K steps with ``steps_per_call=K``); PyTorch runs
eagerly, so here a call runs the K steps in order and returns the K
losses as one device tensor. Nothing in a call reads a device value on
the host, so the host queues the K steps ahead of the device.

A call mirrors the JAX step's order:

- one ``next_key()`` from the default threefry generator per call, with
  or without dropout; K > 1 splits it into K step keys
  (``split(key, K)``), and each step runs its loss under
  ``trace_key_scope`` of its key, so dropout draws the JAX step's keys;
- the learning rate is read once per call: the K steps share it;
- each step: the loss; with an enabled ``scaler``, ``scaler.scale(loss)
  .backward()`` and every gradient times ``1 / scale`` (in its dtype),
  with no inf check and no change of the scale (the JAX branch as it
  is: the check and the scale's update live in the eager
  ``GradScaler.step``); else ``loss.backward()``; then ``grad_clip``,
  the optimizer's update at the call's rate, and the gradients
  cleared.

Shardings are not ported; ``donate`` and ``compiler_options`` (XLA's)
are taken for the JAX signature and have nothing to act on here.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable

import torch

from ..core import random as _rng
from ..core import threefry

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer, steps_per_call=K)``
    then ``losses = step(x, y)``: ``loss_fn(model, x, y)`` returns the
    scalar loss. With ``K > 1`` every tensor argument has a leading
    ``[K]`` axis (step i takes index i) and the call returns the K
    losses ``[K]``; with ``K == 1`` the arguments are used as given and
    the call returns the loss."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 scaler=None, donate=True, in_shardings=None,
                 out_shardings=None, steps_per_call: int = 1,
                 compiler_options=None):
        if in_shardings is not None or out_shardings is not None:
            raise NotImplementedError("sharded train steps are not ported")
        self.steps_per_call = int(steps_per_call)
        if self.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = scaler

    def _backward(self, loss) -> None:
        scaler = self.scaler
        if scaler is None or not scaler._enable:
            loss.backward()
            return
        scaler.scale(loss).backward()
        inv = 1.0 / scaler._scale
        by_dtype = defaultdict(list)
        for p in self.optimizer._params:
            if p.grad is not None:
                by_dtype[p.grad.dtype].append(p.grad)
        for dtype, grads in by_dtype.items():
            torch._foreach_mul_(grads, torch.tensor(inv, dtype=dtype).to(
                grads[0].device))

    def _step(self, key, lr, args, kwargs):
        opt = self.optimizer
        with _rng.trace_key_scope(key):
            loss = self.loss_fn(self.model, *args, **kwargs)
            self._backward(loss)
        with torch.no_grad():
            params_grads = [(p, p.grad) for p in opt._params
                            if p.grad is not None]
            if opt._grad_clip is not None:
                params_grads = opt._grad_clip(params_grads)
            opt._apply(params_grads, lr)
        opt.clear_grad()
        return loss.detach()

    def __call__(self, *args, **kwargs):
        K = self.steps_per_call
        key = _rng.default_generator.next_key()
        lr = self.optimizer.get_lr()
        if K == 1:
            loss = self._step(key, lr, args, kwargs)
            self.optimizer._global_step += 1
            return loss

        def at(x, i):
            return x[i] if isinstance(x, torch.Tensor) else x

        keys = threefry.split(key, K)
        losses = torch.stack([
            self._step(keys[i], lr, [at(a, i) for a in args],
                       {n: at(a, i) for n, a in kwargs.items()})
            for i in range(K)])
        self.optimizer._global_step += K
        return losses
