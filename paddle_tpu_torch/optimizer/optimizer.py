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

The learning rate may be an ``LRScheduler`` (``optimizer/lr.py``), read
once per ``step`` (``TrainStep`` reads it once per call); ``grad_clip``
(``nn/clip.py``) scales the gradients before the update. Adam's
low-memory tiers follow the JAX rule: ``moment_dtype`` stores the
moments rounded to that dtype while the arithmetic runs in the
gradient's dtype; ``beta1=0`` keeps no first moment; with
``factored_moment2`` a parameter of two or more axes keeps float32 row
and column means of ``g^2`` in place of its second moment and divides by
their rank-1 reconstruction (floored at 1e-30), updated one parameter
at a time; ``update_rms_clip`` scales each parameter's update by ``1 /
max(1, RMS(u) / d)``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.tensor import from_numpy
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _true_div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` by a true division (a Python numerator over a
    tensor is otherwise a multiply by the tensor's reciprocal)."""
    return torch.div(torch.full_like(den, num), den)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        # None: a static program's minimize() fills the list
        params = list(parameters) if parameters is not None else []
        # Paddle parameters carry a name; here (name, parameter) pairs,
        # as Module.named_parameters() gives them, name them
        self._names = {id(p): n for n, p in
                       (x for x in params if isinstance(x, tuple))}
        self._parameter_list = [x[1] if isinstance(x, tuple) else x
                                for x in params]
        self._learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._grad_clip = grad_clip
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        # steps taken per parameter (a parameter without a grad skips a
        # step): parameters with equal counts update as one group
        self._steps: Dict[int, int] = {}
        self._global_step = 0

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._learning_rate = scheduler

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

    def _key(self, i: int, p) -> str:
        return self._names.get(id(p)) or f"param_{i}"

    def state_dict(self) -> Dict:
        """The JAX ``Optimizer.state_dict``'s layout: each parameter's
        accumulators as ``"<name>.<accumulator>"`` (``param_<i>`` for a
        parameter given without a name), ``global_step`` and the
        scheduler's state under ``LR_Scheduler``."""
        sd = {}
        for i, p in enumerate(self._parameter_list):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f"{self._key(i, p)}.{k}"] = v
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict) -> None:
        for i, p in enumerate(self._parameter_list):
            st = self._state_for(p)
            for k, v in st.items():
                full = f"{self._key(i, p)}.{k}"
                if full in state_dict:
                    src = state_dict[full]
                    if not isinstance(src, torch.Tensor):
                        src = from_numpy(src)
                    v.copy_(src.to(v.device, v.dtype))
        if "global_step" in state_dict:
            self._global_step = int(state_dict["global_step"])
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                      LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, ``step()``, ``clear_grad()``; on a static
        ``Variable`` loss, register the update with its program (the
        Executor applies it after each run's backward)."""
        from ..core.dispatch import is_symbolic

        if is_symbolic(loss):
            from ..static.backward import static_minimize

            return static_minimize(self, loss, parameters)
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients (``grad_clip``), read the learning rate,
        update every parameter that has a gradient."""
        self._global_step += 1
        params_grads = [(p, p.grad) for p in self._params
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._apply(params_grads, self.get_lr())

    @torch.no_grad()
    def _apply(self, params_grads, lr: float) -> None:
        """The update of each ``(param, grad)`` at ``lr``, in groups of
        parameters that share their step count, master copy, dtype,
        device, decay and accumulators (one ``_foreach_*`` chain each)."""
        groups: Dict[tuple, list] = {}
        for p, g in params_grads:
            if g is None:
                continue
            st = self._state_for(p)
            key = (self._steps.get(id(p), 0), "master_weight" in st,
                   p.dtype, p.device, self._wd_for(p),
                   tuple((k, v.dtype) for k, v in sorted(st.items())))
            groups.setdefault(key, []).append((p, g, st))
            self._steps[id(p)] = key[0] + 1
        for (_, master, _, _, wd, _), items in groups.items():
            params = [st["master_weight"] if master else p
                      for p, _, st in items]
            grads = [g.to(q.dtype) for (_, g, _), q in zip(items, params)]
            self._update(params, grads, [st for *_, st in items], lr, wd)
            if master:
                torch._foreach_copy_([p for p, *_ in items], params)

    def _update(self, params, grads, states, lr, wd) -> None:
        raise NotImplementedError


class SGD(Optimizer):
    """The JAX ``SGD._rule``: ``p - lr (g + wd p)`` (L2 folded into the
    gradient), over float32 (or master) values."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _init_state(self, p):
        return {}

    def _update(self, params, grads, states, lr, wd):
        if wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))


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
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._decoupled_wd = False      # Adam: L2 folded into the grad
        if moment_dtype is not None and not isinstance(moment_dtype,
                                                       torch.dtype):
            moment_dtype = _DTYPES[str(moment_dtype)]
        self._moment_dtype = moment_dtype
        self._factored_moment2 = bool(factored_moment2)
        self._update_rms_clip = (float(update_rms_clip)
                                 if update_rms_clip is not None else None)

    def _factored(self, p) -> bool:
        return self._factored_moment2 and p.dim() >= 2

    def _init_state(self, p):
        md = self._moment_dtype or p.dtype
        one = torch.ones((), dtype=torch.float32, device=p.device)
        st = {"beta1_pow": one, "beta2_pow": one}
        if self._beta1 != 0.0:
            st["moment1"] = torch.zeros(p.shape, dtype=md, device=p.device)
        if self._factored(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            st["moment2_row"] = torch.zeros(p.shape[:-1], **f32)
            st["moment2_col"] = torch.zeros(p.shape[-1:], **f32)
        else:
            st["moment2"] = torch.zeros(p.shape, dtype=md, device=p.device)
        return st

    @staticmethod
    def _moments(states, name, dtype):
        """The group's stored moments ``name`` and working copies in
        ``dtype`` (the same tensors when the dtypes agree)."""
        stored = [st[name] for st in states]
        if stored[0].dtype == dtype:
            return stored, stored
        return stored, [m.to(dtype) for m in stored]

    def _update(self, params, grads, states, lr, wd):
        """The JAX ``Adam._rule`` in place over one group (equal step
        counts, so equal ``beta*_pow``; equal accumulators)."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        dtype = params[0].dtype
        gdt = grads[0].dtype
        if wd and not self._decoupled_wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        b1p = states[0]["beta1_pow"] * b1
        b2p = states[0]["beta2_pow"] * b2
        if "moment1" in states[0]:
            stored, m = self._moments(states, "moment1", gdt)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            if m is not stored:
                torch._foreach_copy_(stored, m)
            u = torch._foreach_div(m, (1 - b1p).to(dtype))
        else:
            u = [g.clone() for g in grads]
        if "moment2" in states[0]:
            stored, v = self._moments(states, "moment2", gdt)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(grads, grads),
                                alpha=1 - b2)
            if v is not stored:
                torch._foreach_copy_(stored, v)
            denom = torch._foreach_div(v, (1 - b2p).to(dtype))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
        else:
            denom = [self._factored_denom(g, st, b2, b2p, eps, dtype)
                     for g, st in zip(grads, states)]
        torch._foreach_div_(u, denom)
        if self._update_rms_clip is not None:
            d = self._update_rms_clip
            for x in u:
                rms = torch.sqrt(torch.mean(torch.square(x.float())))
                x.mul_(_true_div(d, torch.clamp(rms, min=d)).to(x.dtype))
        decay = (torch._foreach_mul(params, lr * wd)
                 if wd and self._decoupled_wd else None)
        torch._foreach_add_(params, u, alpha=-lr)
        if decay is not None:
            torch._foreach_sub_(params, decay)
        for st in states:
            st["beta1_pow"], st["beta2_pow"] = b1p, b2p

    @staticmethod
    def _factored_denom(g, st, b2, b2p, eps, dtype):
        """Update one parameter's row and column factors of ``g^2`` in
        place and return ``sqrt(outer(vr, vc) / mean(vr)) + eps`` from
        their bias-corrected values, in the parameter's dtype."""
        g2 = (g * g).float()
        row, col = st["moment2_row"], st["moment2_col"]
        row.mul_(b2).add_(g2.mean(dim=-1) * (1 - b2))
        col.mul_(b2).add_(g2.mean(dim=tuple(range(g.dim() - 1))) * (1 - b2))
        vr, vc = row / (1 - b2p), col / (1 - b2p)
        scale = torch.clamp(vr.mean(), min=1e-30)
        return (torch.sqrt(vr[..., None] * vc / scale) + eps).to(dtype)


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
