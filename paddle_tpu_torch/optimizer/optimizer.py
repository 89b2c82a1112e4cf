"""Optimizers: ``Momentum``, ``Adam`` and ``AdamW`` with the JAX package's
update rules.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``. The rule is the
JAX ``Adam._rule``, not ``torch.optim.AdamW``'s (which orders its
operations differently): per parameter, float32 ``beta1_pow`` /
``beta2_pow``, ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
bias corrections cast to the parameter's dtype, ``u = mhat / (sqrt(vhat)
+ eps)``, ``p - lr u``, and for AdamW the decoupled decay ``- lr wd p``
on the old ``p``. With ``multi_precision`` a bf16/fp16 parameter keeps a
float32 master copy: the gradient, the moments and the update are
float32 and the parameter is a cast of the new master.

The update runs in place with ``torch._foreach_*`` over groups of
parameters that share their step count, decay and dtype, so a step
issues a few dozen launches and no host sync. Where the JAX rule runs
on bf16 values without a master copy it rounds each Python scalar to
bf16 first; PyTorch computes those products in float32 and rounds once,
so that path (not used by ``amp.decorate``) may differ in the last bf16
bit.

Not ported (each raises ``NotImplementedError``): learning-rate
schedulers, gradient clipping, ``moment_dtype``, ``factored_moment2``,
``update_rms_clip``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported (queued)")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if grad_clip is not None:
            _not_ported("grad_clip")
        if not isinstance(learning_rate, (int, float)):
            _not_ported("an LRScheduler learning rate")
        params = list(parameters)
        # Paddle parameters carry a name; here (name, parameter) pairs,
        # as Module.named_parameters() gives them, name them
        self._names = {id(p): n for n, p in
                       (x for x in params if isinstance(x, tuple))}
        self._parameter_list = [x[1] if isinstance(x, tuple) else x
                                for x in params]
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        # steps taken per parameter (a parameter without a grad skips a
        # step): parameters with equal counts update as one group
        self._steps: Dict[int, int] = {}
        self._global_step = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

    @property
    def _params(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list if p.requires_grad]

    def _uses_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _state_for(self, p) -> Dict[str, torch.Tensor]:
        """The parameter's accumulators, made at its first step: those of
        ``_init_state`` plus, with ``multi_precision`` for a bf16/fp16
        parameter, a float32 ``master_weight`` (the moments are then
        float32 too)."""
        st = self._accumulators.get(id(p))
        if st is None:
            if self._uses_master(p):
                master = p.detach().float()
                st = self._init_state(master)
                st["master_weight"] = master
            else:
                st = self._init_state(p.detach())
            self._accumulators[id(p)] = st
        return st

    def _init_state(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _wd_for(self, p) -> float:
        return self._weight_decay

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self._global_step += 1
        lr = self.get_lr()
        groups: Dict[tuple, list] = {}
        for p in self._params:
            if p.grad is None:
                continue
            st = self._state_for(p)
            key = (self._steps.get(id(p), 0), "master_weight" in st,
                   p.dtype, p.device, self._wd_for(p))
            groups.setdefault(key, []).append((p, st))
            self._steps[id(p)] = key[0] + 1
        for (_, master, _, _, wd), items in groups.items():
            params = [st["master_weight"] if master else p for p, st in items]
            grads = [p.grad.to(q.dtype) for (p, _), q in zip(items, params)]
            self._update(params, grads, [st for _, st in items], lr, wd)
            if master:
                torch._foreach_copy_([p for p, _ in items], params)

    def _update(self, params, grads, states, lr, wd) -> None:
        raise NotImplementedError


class Momentum(Optimizer):
    """The JAX ``Momentum._rule`` over float32 (or master) values: ``g +
    wd p`` (L2 folded into the gradient), ``v = momentum v + g``, then
    ``p - lr v``, or with ``use_nesterov`` ``p - lr (g + momentum v)``,
    each product rounded before its sum as in JAX."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, params, grads, states, lr, wd):
        mu = self._momentum
        if wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        v = [st["velocity"] for st in states]
        torch._foreach_mul_(v, mu)
        torch._foreach_add_(v, grads)
        if self._nesterov:
            step = torch._foreach_add(grads, torch._foreach_mul(v, mu))
        else:
            step = v
        torch._foreach_sub_(params, torch._foreach_mul(step, lr))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, moment_dtype=None,
                 factored_moment2=False, update_rms_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        if moment_dtype is not None:
            _not_ported("moment_dtype (low-memory moments)")
        if factored_moment2:
            _not_ported("factored_moment2")
        if update_rms_clip is not None:
            _not_ported("update_rms_clip")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._decoupled_wd = False      # Adam: L2 folded into the grad

    def _init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"beta1_pow": one, "beta2_pow": one,
                "moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _update(self, params, grads, states, lr, wd):
        """The JAX ``Adam._rule`` in place over one group (equal step
        counts, so equal ``beta*_pow``)."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        dtype = params[0].dtype
        if wd and not self._decoupled_wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        b1p = states[0]["beta1_pow"] * b1
        b2p = states[0]["beta2_pow"] * b2
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(grads, grads), alpha=1 - b2)
        u = torch._foreach_div(m, (1 - b1p).to(dtype))
        denom = torch._foreach_div(v, (1 - b2p).to(dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(u, denom)
        decay = (torch._foreach_mul(params, lr * wd)
                 if wd and self._decoupled_wd else None)
        torch._foreach_add_(params, u, alpha=-lr)
        if decay is not None:
            torch._foreach_sub_(params, decay)
        for st in states:
            st["beta1_pow"], st["beta2_pow"] = b1p, b2p


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, moment_dtype=None,
                 factored_moment2=False, update_rms_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         moment_dtype, factored_moment2, update_rms_clip)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_for(self, p) -> float:
        """The decay of ``p``: 0 where ``apply_decay_param_fun(name)`` is
        false, ``name`` the one given with ``p`` (``""`` if none)."""
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names.get(id(p), "")):
            return 0.0
        return self._weight_decay
