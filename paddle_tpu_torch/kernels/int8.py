"""Symmetric absmax int8 quantization.

Counterpart of ``paddle_tpu/kernels/int8.py``'s ``quantize_absmax`` and
``dequantize`` (the glue the weight-only int8 serving path and the int8
KV pages share): float32 arithmetic, round half to even, codes clipped
to +-127, scales floored at 1e-8 so an all-zero row quantizes to zeros
rather than NaN. Bit for bit the JAX package's codes and scales.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["quantize_absmax", "dequantize"]

INT8_QMAX = 127.0
SCALE_EPS = 1e-8


def quantize_absmax(x: torch.Tensor, axis: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q int8, scale float32)``. ``axis`` picks per-channel
    scales, kept as a size-1 axis so dequantization is a broadcast
    multiply; ``None`` takes one scale for the whole tensor (0-d)."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / INT8_QMAX, min=SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q x scale`` in float32 (``scale`` broadcasts), cast to
    ``dtype``."""
    return (q.to(torch.float32) * scale).to(dtype)
