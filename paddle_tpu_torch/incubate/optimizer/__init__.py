"""``paddle.incubate.optimizer``: ``LookAhead`` and ``ModelAverage``
(counterpart of ``paddle_tpu/incubate/optimizer/__init__.py``).

Two reference quirks are kept (ROADMAP queue C): ``LookAhead`` seeds its
slow weights at the first sync point (step ``k``), not from the initial
parameters, and ``ModelAverage`` is a plain running mean that restarts
once it holds ``max_average_window`` steps (``min_average_window`` is
accepted and inert). Both work in place on the parameters' devices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...core.tensor import from_numpy

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """``slow += alpha (fast - slow)`` and ``fast = slow`` every ``k``
    steps of ``inner_optimizer``."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if k < 1:
            raise ValueError("k must be >= 1")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_count = 0
        self._slow: Dict[int, torch.Tensor] = {}

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k:
            return
        for p in self.inner_optimizer._parameter_list:
            slow = self._slow.get(id(p))
            if slow is None:
                self._slow[id(p)] = p.detach().clone()
                continue
            slow.add_((p - slow) * self.alpha)
            p.copy_(slow)

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        self.inner_optimizer.clear_grad()
        return None, None

    def clear_grad(self, *args, **kwargs):
        self.inner_optimizer.clear_grad(*args, **kwargs)

    def state_dict(self):
        """The inner optimizer's, plus ``lookahead_step`` and the slow
        weights under ``lookahead_slow`` by position in the inner
        parameter list."""
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_step"] = self._step_count
        sd["lookahead_slow"] = {
            i: self._slow[id(p)].detach().clone()
            for i, p in enumerate(self.inner_optimizer._parameter_list)
            if id(p) in self._slow}
        return sd

    def set_state_dict(self, state_dict):
        sd = dict(state_dict)
        self._step_count = int(sd.pop("lookahead_step", 0))
        slow = sd.pop("lookahead_slow", {})
        self._slow = {}
        for i, p in enumerate(self.inner_optimizer._parameter_list):
            if i in slow:
                v = slow[i]
                v = v if isinstance(v, torch.Tensor) else from_numpy(v)
                self._slow[id(p)] = v.detach().to(p.device, p.dtype).clone()
        self.inner_optimizer.set_state_dict(sd)


class ModelAverage:
    """A running sum of the parameters after each ``step()``;
    ``apply()`` puts their mean in place (``restore()`` puts the
    training values back, bit for bit)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError("ModelAverage requires parameters")
        self._params = [x[1] if isinstance(x, tuple) else x
                        for x in parameters]
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = self._zeros()
        self._count = 0
        self._saved: Optional[Dict[int, torch.Tensor]] = None

    def _zeros(self):
        return {id(p): torch.zeros_like(p.detach()) for p in self._params}

    @torch.no_grad()
    def step(self):
        if self._count >= self._max_w:
            self._sum = self._zeros()
            self._count = 0
        self._count += 1
        for p in self._params:
            self._sum[id(p)].add_(p)

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            return
        self._saved = {id(p): p.detach().clone() for p in self._params}
        for p in self._params:
            s = self._sum[id(p)]
            p.copy_(torch.div(s, torch.full_like(s, self._count)))
        if not need_restore:
            self._saved = None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._saved is None:
            return
        for p in self._params:
            p.copy_(self._saved[id(p)])
        self._saved = None
