"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

The clips take and return ``(param, grad)`` lists, as the optimizers
apply them before their update. Norms are float32 sums of squares of
the gradients cast to float32 (float64 where a gradient is float64); a
clip factor ``min(clip_norm /
max(norm, 1e-12), 1)`` multiplies each gradient in its own dtype. The
global norm stays one device value: no host read per parameter or per
step.
"""
from __future__ import annotations

import math
from typing import List

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _sq_norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's float32 sum of squares (float64 where a gradient
    is float64), one multi-tensor pass."""
    wide = torch.float64 if any(g.dtype == torch.float64 for g in grads) \
        else torch.float32
    return [n * n for n in torch._foreach_norm(grads, 2, dtype=wide)]


def _factor(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(clip_norm / max(norm, 1e-12), 1)`` by a true division
    (``float / tensor`` would multiply by the tensor's reciprocal)."""
    return torch.clamp(torch.div(torch.full_like(norm, clip_norm),
                                 torch.clamp(norm, min=1e-12)), max=1.0)


def _scaled(g: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return (g * factor).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by its own norm's factor."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        norms = iter(torch.sqrt(s) for s in _sq_norms(grads)) if grads \
            else iter(())
        return [(p, g if g is None else
                 _scaled(g, _factor(next(norms), self.clip_norm)))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by the factor of the norm over all of
    them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        sq = _sq_norms(grads)
        total = sq[0].to(grads[0].device)
        for s in sq[1:]:
            total = total + s.to(total.device)
        factor = _factor(torch.sqrt(total), self.clip_norm)
        return [(p, g if g is None else _scaled(g, factor.to(g.device)))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    max(total, 1e-12), 1)``; ``total`` is the ``norm_type`` norm over
    every gradient (float32; the largest ``|g|`` for ``inf``). Returns
    ``total`` as a device tensor."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.tensor(0.0)
    grads = [p.grad for p in params]
    if norm_type == math.inf:
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([
            (g.float().abs() ** norm_type).sum() for g in grads
        ]).sum() ** (1.0 / norm_type)
    factor = _factor(total, float(max_norm))
    for p in params:
        p.grad = _scaled(p.grad, factor)
    return total
