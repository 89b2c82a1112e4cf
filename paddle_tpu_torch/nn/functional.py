"""Functional ops of the port's layers, with Paddle's arguments and
semantics: counterparts of ``paddle_tpu/ops/nn_ops.py``'s ``linear``,
``layer_norm``, ``gelu``, ``relu``, ``conv2d``, ``max_pool2d``,
``adaptive_avg_pool2d``, ``batch_norm`` and ``cross_entropy``.

Only the NCHW layout is ported; the channel-last forms raise. The
convolutions and pools are PyTorch's (cuDNN on the card), as the JAX
package leaves them to XLA: no TPU kernel of the JAX package computes
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear", "layer_norm", "gelu", "relu", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "batch_norm", "cross_entropy"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight. It runs
    as one GEMM on the weight's transposed view (no copy) with the bias
    added in the GEMM's epilogue: in bf16 the sum rounds once, where the
    JAX form rounds the product and then the sum."""
    return F.linear(x, weight.t(), bias)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """LayerNorm over the last ``len(normalized_shape)`` axes in float32
    (mean, population variance, ``rsqrt(var + eps)``, then ``* weight +
    bias`` where given, each reshaped to ``normalized_shape``), cast back
    to x's dtype: the JAX package's ``layer_norm``."""
    shape = ((int(normalized_shape),) if isinstance(normalized_shape, int)
             else tuple(int(n) for n in normalized_shape))
    w, b = (None if t is None else t.float().reshape(shape)
            for t in (weight, bias))
    return F.layer_norm(x.float(), shape, w, b, epsilon).to(x.dtype)


def gelu(x, approximate: bool = False, name=None):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default, which the GPT model uses)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return F.relu(x)


def _pair(v):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * 2


def _nchw(data_format):
    if data_format != "NCHW":
        raise NotImplementedError(f"data_format={data_format!r}: only NCHW "
                                  "is ported")


def _conv_padding(padding, x, kernel, stride, dilation=(1, 1)):
    """Paddle's padding spec as ``(lo, hi)`` pads of H and W: an int,
    ``[h, w]``, or ``"SAME"``/``"VALID"``; the four-sided forms are not
    ported. ``"SAME"`` pads as XLA's does: ``ceil(n / stride)`` outputs,
    the total pad ``max((out - 1) * stride + (k - 1) * dilation + 1 - n,
    0)`` split with the odd element on the high side."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode != "SAME":
            raise ValueError(f"padding {padding!r}")
        pads = []
        for n, k, s, d in zip(x.shape[2:], kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * 2
    if len(padding) != 2:
        raise NotImplementedError(f"padding {padding}: only [h, w] is "
                                  "ported")
    return [(int(p), int(p)) for p in padding]


def _pad_input(x, pads, value=0.0):
    """``(x, padding)`` for a torch convolution or pool: symmetric pads
    stay the op's own padding; uneven ones go into one ``F.pad`` of x
    ahead of it (with ``value``), and the op pads nothing."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    (h0, h1), (w0, w1) = pads
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, weight ``[out, in / groups, kh, kw]``; the
    output keeps x's dtype."""
    _nchw(data_format)
    stride, dilation = _pair(stride), _pair(dilation)
    x, pad = _pad_input(x, _conv_padding(padding, x, weight.shape[2:],
                                         stride, dilation))
    return F.conv2d(x, weight, bias, stride, pad, dilation, groups)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max pooling; padding counts as ``-inf`` (an integer input's
    least value), as in the JAX package, whose string paddings take no
    ceil mode."""
    _nchw(data_format)
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported")
    k = _pair(kernel_size)
    stride = _pair(stride) if stride is not None else k
    low = (float("-inf") if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    x, pad = _pad_input(x, _conv_padding(padding, x, k, stride), low)
    return F.max_pool2d(x, k, stride, pad,
                        ceil_mode=ceil_mode and not isinstance(padding, str))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the windows ``[floor(i * n / out), ceil((i + 1) * n /
    out))`` of each axis: the JAX package's strided average where the
    output size divides the input and its averaging-matrix einsum
    elsewhere. Sums in float32 for any input dtype."""
    _nchw(data_format)
    return F.adaptive_avg_pool2d(x, _pair(output_size))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalisation of an NCHW input over N, H and W.

    With batch statistics (``training`` unless ``use_global_stats``)
    it normalises by the batch mean and population variance and updates
    the running statistics in place, Paddle's ``r = momentum * r + (1 -
    momentum) * batch`` with the unbiased variance (torch's ``momentum``
    is ``1 - momentum``); otherwise it normalises by the running
    statistics. The statistics and the normalisation are float32 for a
    bfloat16/float16 input (PyTorch accumulates reduced types in
    float32), the output has x's dtype, and the running statistics keep
    theirs: the JAX package's rounding points, except that a bf16
    running statistic rounds once per update where JAX rounds each
    product."""
    _nchw(data_format)
    if x.ndim != 4:
        raise NotImplementedError(f"batch_norm of a {x.ndim}-d input: only "
                                  "NCHW is ported")
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if not use_stats and x.numel() == x.shape[1]:
        return _batch_norm_one_value(x, running_mean, running_var, weight,
                                     bias, momentum, epsilon)
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=not use_stats, momentum=1.0 - momentum,
                        eps=epsilon)


def _batch_norm_one_value(x, running_mean, running_var, weight, bias,
                          momentum, epsilon):
    """Batch statistics over one value per channel (``[1, C, 1, 1]``),
    which ``F.batch_norm`` refuses: the JAX package's formula as it
    stands, so the output is the bias (0 without one), the batch
    variance 0, and the running variance takes ``0 * n / max(n - 1, 1)``
    with n = 1."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    out = (xf - mean[:, None, None]) * torch.rsqrt(var + epsilon)[:, None,
                                                                   None]
    if weight is not None:
        out = out * weight[:, None, None] + bias[:, None, None]
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                ((1 - momentum) * mean).to(running_mean.dtype))
            running_var.mul_(momentum).add_(
                ((1 - momentum) * var).to(running_var.dtype))
    return out.to(x.dtype)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy of ``input [N, C]`` against integer labels
    ``[N]``, averaged over the rows whose label is not ``ignore_index``
    (0 when every row is ignored, where ``F.cross_entropy`` would give
    NaN). Only this path is ported: other reductions and label shapes,
    class weights, soft labels and smoothing raise."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing or reduction != "mean" or input.ndim != 2
            or label.ndim != 1 or axis not in (-1, 1)):
        raise NotImplementedError("cross_entropy: only the mean over hard "
                                  "labels [N] of input [N, C] is ported")
    losses = F.cross_entropy(input, label.long(), ignore_index=ignore_index,
                             reduction="none")
    count = (label != ignore_index).sum().clamp(min=1)
    return losses.sum() / count.to(losses.dtype)
