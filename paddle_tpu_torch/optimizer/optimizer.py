"""Optimizers: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``,
``Adadelta``, ``Adamax``, ``RMSProp``, ``Lamb`` and ``Lars`` with the
JAX package's update rules.

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

The constructors take the JAX package's arguments in its order. As
there, ``parameters`` may be a list of parameter groups (dicts whose
``"params"`` are flattened; their other keys are ignored),
``weight_decay`` a number or a regularizer object (``L2Decay(c)`` /
``L1Decay(c)``: its coefficient, decaying as L2 in every rule), and
``name``, Adam's ``lazy_mode`` / ``use_multi_tensor`` and AdamW's
``lr_ratio`` are accepted and change nothing. ``Lamb`` and ``Lars``
take per-parameter float32 norms (one reduction a parameter).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.tensor import from_numpy
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _true_div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` by a true division (a Python numerator over a
    tensor is otherwise a multiply by the tensor's reciprocal)."""
    return torch.div(torch.full_like(den, num), den)


def _l2(params, grads, wd):
    """``g + wd p`` (the product rounded before the sum, as in JAX), or
    the gradients as they are when ``wd`` is 0."""
    if not wd:
        return grads
    return torch._foreach_add(grads, torch._foreach_mul(params, wd))


def _float_norms(xs) -> torch.Tensor:
    """Each tensor's L2 norm over its float32 values, stacked."""
    return torch.stack(torch._foreach_norm(
        [x if x.dtype == torch.float32 else x.float() for x in xs]))


def _wd_value(weight_decay) -> float:
    """The JAX ``Optimizer._wd_value``: None is 0, a regularizer object
    gives its ``_coeff``, anything else goes through ``float``."""
    if weight_decay is None:
        return 0.0
    if hasattr(weight_decay, "_coeff"):
        return float(weight_decay._coeff)
    return float(weight_decay)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        # None: a static program's minimize() fills the list
        params = list(parameters) if parameters is not None else []
        if params and isinstance(params[0], dict):
            # parameter groups: their "params" in order, other keys ignored
            params = [x for group in params for x in group["params"]]
        # Paddle parameters carry a name; here (name, parameter) pairs,
        # as Module.named_parameters() gives them, name them
        self._names = {id(p): n for n, p in
                       (x for x in params if isinstance(x, tuple))}
        self._parameter_list = [x[1] if isinstance(x, tuple) else x
                                for x in params]
        self._learning_rate = (learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate))
        self._grad_clip = grad_clip
        self._weight_decay = _wd_value(weight_decay)
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

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every parameter's gradient, or with ``set_to_zero``
        replace it by zeros."""
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad = torch.zeros_like(p.grad)
            else:
                p.grad = None

    clear_gradients = clear_grad

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
                         multi_precision=multi_precision)

    def _init_state(self, p):
        return {}

    def _update(self, params, grads, states, lr, wd):
        grads = _l2(params, grads, wd)
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
                         multi_precision=multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, params, grads, states, lr, wd):
        mu = self._momentum
        grads = _l2(params, grads, wd)
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
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, moment_dtype=None,
                 factored_moment2=False, update_rms_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
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
        st = {k: torch.ones((), dtype=torch.float32, device=p.device)
              for k in ("beta1_pow", "beta2_pow")}
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
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, moment_dtype=None,
                 factored_moment2=False, update_rms_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision,
                         moment_dtype=moment_dtype,
                         factored_moment2=factored_moment2,
                         update_rms_clip=update_rms_clip)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_for(self, p) -> float:
        """The decay of ``p``: 0 where ``apply_decay_param_fun(name)`` is
        false, ``name`` the one given with ``p`` (``""`` if none)."""
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names.get(id(p), "")):
            return 0.0
        return self._weight_decay


def _decay(xs, factor: float, add) -> None:
    """``x = factor x + add`` in place over the lists (``add`` already
    holds its own factor)."""
    torch._foreach_mul_(xs, factor)
    torch._foreach_add_(xs, add)


def _sqrt_plus(xs, eps: float, inside: bool):
    """``sqrt(x + eps)`` (``inside``) or ``sqrt(x) + eps``, new lists."""
    if inside:
        out = torch._foreach_add(xs, eps)
        torch._foreach_sqrt_(out)
        return out
    out = torch._foreach_sqrt(xs)
    torch._foreach_add_(out, eps)
    return out


class Adagrad(Optimizer):
    """The JAX ``Adagrad._rule``: ``m += g^2``, ``p - lr g / (sqrt(m) +
    eps)``, decay folded into the gradient."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_val)}

    def _update(self, params, grads, states, lr, wd):
        grads = _l2(params, grads, wd)
        m = [st["moment"] for st in states]
        torch._foreach_add_(m, torch._foreach_mul(grads, grads))
        step = torch._foreach_mul(grads, lr)
        torch._foreach_div_(step, _sqrt_plus(m, self._epsilon, False))
        torch._foreach_sub_(params, step)


class Adadelta(Optimizer):
    """The JAX ``Adadelta._rule``: running means of ``g^2`` and of the
    squared update, ``u = g sqrt(E[u^2] + eps) / sqrt(E[g^2] + eps)``
    (the old ``E[u^2]``), ``p - lr u``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, p):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    def _update(self, params, grads, states, lr, wd):
        rho, eps = self._rho, self._epsilon
        grads = _l2(params, grads, wd)
        asg = [st["avg_sq_grad"] for st in states]
        asu = [st["avg_sq_update"] for st in states]
        _decay(asg, rho, torch._foreach_mul(
            torch._foreach_mul(grads, 1 - rho), grads))
        update = torch._foreach_mul(grads, _sqrt_plus(asu, eps, True))
        torch._foreach_div_(update, _sqrt_plus(asg, eps, True))
        _decay(asu, rho, torch._foreach_mul(
            torch._foreach_mul(update, 1 - rho), update))
        torch._foreach_sub_(params, torch._foreach_mul(update, lr))


class Adamax(Optimizer):
    """The JAX ``Adamax._rule``: ``m = b1 m + (1 - b1) g``, ``u =
    max(b2 u, |g|)``, ``p - (lr / (1 - b1^t)) m / (u + eps)``, the
    bias-corrected rate a true division cast to the parameter's
    dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, params, grads, states, lr, wd):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        grads = _l2(params, grads, wd)
        m = [st["moment"] for st in states]
        u = [st["inf_norm"] for st in states]
        _decay(m, b1, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        b1p = states[0]["beta1_pow"] * b1
        step = torch._foreach_mul(m, _true_div(lr, 1 - b1p).to(
            params[0].dtype))
        torch._foreach_div_(step, torch._foreach_add(u, eps))
        torch._foreach_sub_(params, step)
        for st in states:
            st["beta1_pow"] = b1p


class RMSProp(Optimizer):
    """The JAX ``RMSProp._rule``: ``E[g^2] = rho E[g^2] + (1 - rho)
    g^2``, with ``centered`` less ``E[g]^2``; ``mom = momentum mom + lr g
    / sqrt(. + eps)``; ``p - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p),
              "momentum": torch.zeros_like(p)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p)
        return st

    def _update(self, params, grads, states, lr, wd):
        rho, eps = self._rho, self._epsilon
        grads = _l2(params, grads, wd)
        ms = [st["mean_square"] for st in states]
        _decay(ms, rho, torch._foreach_mul(
            torch._foreach_mul(grads, 1 - rho), grads))
        inner = ms
        if self._centered:
            mg = [st["mean_grad"] for st in states]
            _decay(mg, rho, torch._foreach_mul(grads, 1 - rho))
            inner = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
        step = torch._foreach_mul(grads, lr)
        torch._foreach_div_(step, _sqrt_plus(inner, eps, True))
        mom = [st["momentum"] for st in states]
        _decay(mom, self._momentum, step)
        torch._foreach_sub_(params, mom)


class Lamb(Optimizer):
    """The JAX ``Lamb._rule`` (arXiv:1904.00962): Adam's moments with
    bias corrections cast to the parameter's dtype, ``r = mhat /
    (sqrt(vhat) + eps) + wd p``, and the trust ratio ``|p| / |r|`` of
    float32 norms (1 where either is 0): ``p - (lr trust) r``.
    ``exclude_from_weight_decay_fn(p)`` (given the parameter) true: no
    decay for ``p``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision=multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        st = {k: torch.ones((), dtype=torch.float32, device=p.device)
              for k in ("beta1_pow", "beta2_pow")}
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p),
                **st}

    def _wd_for(self, p) -> float:
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return self._weight_decay

    def _update(self, params, grads, states, lr, wd):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        dtype = params[0].dtype
        b1p = states[0]["beta1_pow"] * b1
        b2p = states[0]["beta2_pow"] * b2
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        _decay(m, b1, torch._foreach_mul(grads, 1 - b1))
        _decay(v, b2, torch._foreach_mul(
            torch._foreach_mul(grads, 1 - b2), grads))
        r = torch._foreach_div(m, (1 - b1p).to(dtype))
        vhat = torch._foreach_div(v, (1 - b2p).to(dtype))
        torch._foreach_div_(r, _sqrt_plus(vhat, eps, False))
        torch._foreach_add_(r, torch._foreach_mul(params, wd))
        w, rn = _float_norms(params), _float_norms(r)
        trust = torch.where((w > 0) & (rn > 0), w / rn,
                            torch.ones_like(w)).to(dtype) * lr
        for p, x, t in zip(params, r, trust):
            p.sub_(x.mul_(t))
        for st in states:
            st["beta1_pow"], st["beta2_pow"] = b1p, b2p


class Lars(Momentum):
    """The JAX ``Lars._rule``: the local rate ``coeff |p| / (|g| + wd
    |p| + eps)`` of float32 norms (1 where either is 0), ``v = momentum
    v + (local lr) (g + wd p)``, ``p - v``. A parameter whose name
    (given in a ``(name, parameter)`` pair) contains a string of
    ``exclude_from_weight_decay`` takes no decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=1e-9,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, momentum, parameters, False,
                         lars_weight_decay, grad_clip, multi_precision, name)
        self._lars_coeff = lars_coeff
        self._lars_eps = epsilon
        self._exclude_names = list(exclude_from_weight_decay or [])

    def _wd_for(self, p) -> float:
        name = self._names.get(id(p), "")
        if any(s in name for s in self._exclude_names):
            return 0.0
        return self._weight_decay

    def _update(self, params, grads, states, lr, wd):
        w, g = _float_norms(params), _float_norms(grads)
        local = torch.where((w > 0) & (g > 0), self._lars_coeff * w / (
            g + wd * w + self._lars_eps), torch.ones_like(w)).to(
                params[0].dtype) * lr
        step = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        v = [st["velocity"] for st in states]
        torch._foreach_mul_(v, self._momentum)
        for x, s, t in zip(v, step, local):
            x.add_(s.mul_(t))
        torch._foreach_sub_(params, v)
