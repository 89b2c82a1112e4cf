"""``GradScaler`` (``AmpScaler``): dynamic loss scaling for float16.

Counterpart of ``paddle_tpu/amp/grad_scaler.py``, with its quirks:
``step`` calls ``update`` itself, ``unscale_`` is skipped once already
done in a step, and ``update`` resets the found-inf flag. ``unscale_``
multiplies every gradient by ``1 / scale`` rounded to the gradient's
dtype (the JAX ``g * inv`` with a Python float), in place, and checks
them for inf and NaN with one multi-tensor pass on the device
(``torch._amp_foreach_non_finite_check_and_unscale_``, which tests each
value before its scaling; a finite value times ``1 / scale <= 1`` stays
finite); the step reads the flag on the host once.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        """``var * scale``: the scale rounded to var's dtype, as the JAX
        ``scale`` op multiplies by a Python float."""
        if not self._enable:
            return var
        return var * torch.tensor(self._scale, dtype=var.dtype)

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        groups: Dict[tuple, List[torch.Tensor]] = {}
        for p in optimizer._parameter_list:
            if p.grad is not None:
                groups.setdefault((p.grad.dtype, p.grad.device),
                                  []).append(p.grad)
        found = None
        for (dtype, device), grads in groups.items():
            flag = torch.zeros((), dtype=torch.float32, device=device)
            inv_t = torch.tensor(inv, dtype=dtype).to(torch.float32).to(
                device)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, flag,
                                                             inv_t)
            found = flag if found is None else found + flag.to(found.device)
        self._found_inf = bool(found.item()) if found is not None else False
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)  # no-op if the user already unscaled
        if not self._found_inf:
            optimizer.step()
        self.update()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        # the caller has run backward already, as in Paddle
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
            "enable": self._enable,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


AmpScaler = GradScaler
