"""Functional ops of the layers the GPT model needs, with Paddle's
semantics (counterparts of ``paddle_tpu/ops/nn_ops.py``'s ``linear``,
``layer_norm``, ``gelu`` and ``cross_entropy``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear", "layer_norm", "gelu", "cross_entropy"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight. It runs
    as one GEMM on the weight's transposed view (no copy) with the bias
    added in the GEMM's epilogue: in bf16 the sum rounds once, where the
    JAX form rounds the product and then the sum."""
    return F.linear(x, weight.t(), bias)


def layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis in float32 (mean, population
    variance, ``rsqrt(var + eps)``, then ``* weight + bias``), cast back
    to x's dtype: the JAX package's ``layer_norm`` and the fused stack's
    ``_ln`` alike."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), epsilon).to(x.dtype)


def gelu(x, approximate: bool = False):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default, which the GPT model uses)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def cross_entropy(input, label, ignore_index: int = -100):  # noqa: A002
    """Softmax cross-entropy over the last axis of ``input [N, C]`` with
    integer labels ``[N]``, averaged over the rows whose label is not
    ``ignore_index`` (0 when every row is ignored, where
    ``F.cross_entropy`` would give NaN). Only the path the GPT loss uses:
    Paddle's weights, soft labels and smoothing are not ported."""
    losses = F.cross_entropy(input, label.long(), ignore_index=ignore_index,
                             reduction="none")
    count = (label != ignore_index).sum().clamp(min=1)
    return losses.sum() / count.to(losses.dtype)
