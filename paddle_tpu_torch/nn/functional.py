"""Functional ops of the port's layers, with Paddle's arguments and
semantics: counterparts of ``paddle_tpu/ops/nn_ops.py``'s ``linear``,
``layer_norm``, ``gelu``, ``relu``, ``softmax``, ``dropout``,
``dropout2d``, ``dropout3d``, ``alpha_dropout``,
``scaled_dot_product_attention``, ``conv2d``, ``max_pool2d``,
``adaptive_avg_pool2d`` and ``batch_norm``, and the loss family of
``nn_ops.py:897-1118``: ``cross_entropy``, ``softmax_with_cross_entropy``,
``nll_loss``, ``mse_loss``, ``l1_loss``, ``smooth_l1_loss``,
``binary_cross_entropy``, ``binary_cross_entropy_with_logits``,
``kl_div`` and ``margin_ranking_loss``.

The ops that the JAX dispatcher casts under ``amp.auto_cast`` ask
``amp_cast`` under the JAX op's name before they run (see
``amp/auto_cast.py``). Dropout draws its key from the threefry
generator (``core/random.py``) and runs the dropout kernel on the card
(``kernels/dropout.py``); no key is drawn where nothing is dropped.

Only the NCHW layout is ported; the channel-last forms raise. The
convolutions and pools are PyTorch's (cuDNN on the card), as the JAX
package leaves them to XLA: no TPU kernel of the JAX package computes
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_cast
from ..core import random as _rng
from ..kernels import dropout as _dropout

__all__ = ["linear", "layer_norm", "gelu", "relu", "softmax", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout",
           "scaled_dot_product_attention", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "batch_norm", "cross_entropy",
           "softmax_with_cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight. It runs
    as one GEMM on the weight's transposed view (no copy) with the bias
    added in the GEMM's epilogue: in bf16 the sum rounds once, where the
    JAX form rounds the product and then the sum."""
    x, weight, bias = amp_cast("linear" if bias is not None
                               else "linear_nobias", x, weight, bias)
    return F.linear(x, weight.t(), bias)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """LayerNorm over the last ``len(normalized_shape)`` axes in float32
    (mean, population variance, ``rsqrt(var + eps)``, then ``* weight +
    bias`` where given, each reshaped to ``normalized_shape``), cast back
    to x's dtype: the JAX package's ``layer_norm``."""
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    shape = ((int(normalized_shape),) if isinstance(normalized_shape, int)
             else tuple(int(n) for n in normalized_shape))
    w, b = (None if t is None else t.float().reshape(shape)
            for t in (weight, bias))
    return F.layer_norm(x.float(), shape, w, b, epsilon).to(x.dtype)


def gelu(x, approximate: bool = False, name=None):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default, which the GPT model uses)."""
    x, = amp_cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return F.relu(x)


def softmax(x, axis: int = -1, dtype=None, name=None):
    """Softmax over ``axis`` (``jax.nn.softmax``), in x's dtype."""
    x, = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None):
    """Paddle's dropout (``paddle_tpu/ops/nn_ops.py:273``). Not training
    or ``p == 0``: x as it is (``downscale_in_infer`` at inference: ``x
    * (1 - p)`` with ``1 - p`` in x's dtype), no key drawn; ``p == 1``:
    zeros, cut from the graph as the JAX ``zeros_like``. Else one key from the threefry generator and the mask
    ``bernoulli(key, 1 - p, mask_shape)``, one draw per element or,
    with ``axis``, per index of those axes (the others broadcast; a
    negative axis names none, as in the JAX package);
    ``upscale_in_train`` divides the kept values by ``1 - p``."""
    x, = amp_cast("dropout", x)
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * torch.tensor(1.0 - p, dtype=x.dtype)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    key = _rng.next_key()
    mask_shape = None
    if axis is not None:
        # the raw axes, as the JAX package keeps them: a negative or
        # out-of-range axis matches no dimension (one draw in all)
        axes = [axis] if isinstance(axis, int) else list(axis)
        mask_shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    return _dropout.dropout(x, key, p, mask_shape,
                            upscale=mode == "upscale_in_train")


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", name=None):
    """One draw per (sample, channel), broadcast over H and W."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", name=None):
    """One draw per (sample, channel), broadcast over D, H and W."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p: float = 0.5, training: bool = True, name=None):
    """Alpha dropout (SELU networks): dropped values take ``-alpha *
    scale``, then ``a * x + b`` keeps the mean and variance, each step
    in x's dtype as the JAX package's. The keep mask is the dropout
    kernel's (``downscale_in_infer`` on ones) on the card."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    key = _rng.next_key()
    keep = _dropout.dropout(torch.ones_like(x), key, p,
                            upscale=False) != 0
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    c = lambda v: torch.tensor(v, dtype=x.dtype)   # noqa: E731
    return torch.where(keep, x, c(alpha_p).to(x.device)) * c(a) + c(b)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 tier: str = "auto"):
    """Attention on ``[B, S, H, D]`` through ``kernels.attention``'s
    dispatcher, with attention-probability dropout only in training
    (the JAX ``sdpa`` op). ``tier`` reaches the flash route only."""
    from ..kernels.attention import sdpa_array

    q, k, v, m = amp_cast("sdpa", query, key, value, attn_mask)
    return sdpa_array(q, k, v, mask=m, is_causal=is_causal,
                      dropout_p=dropout_p if training else 0.0, tier=tier)


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


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _pick(logp, label, axis, ignore_index):
    """``(picked, valid, safe)``: the log-probability at each row's label
    along ``axis`` (0 where the label is ``ignore_index``), the mask of
    labels kept and the labels with the ignored ones set to 0. The JAX
    ``take_along_axis`` of ``label[..., None]``, broadcast alike."""
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = torch.take_along_dim(logp, safe[..., None], dim=axis)[..., 0]
    return picked, valid, safe


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Paddle's cross-entropy (``paddle_tpu/ops/nn_ops.py:897``): the
    log-softmax over ``axis`` (``use_softmax=False``: the log of the
    input clipped to ``[1e-10, 1]``) against soft labels (smoothed
    toward ``1 / C``, times the class weights) or hard labels (``[N]`` or
    ``[N, 1]``; ``label_smoothing`` mixes in the mean log-probability;
    rows labelled ``ignore_index`` count 0). ``mean`` over hard labels
    divides by the rows kept (at least 1), or with ``weight`` by their
    weights' sum (at least 1e-9); ``sum`` and ``none`` as named."""
    input, label, weight = amp_cast("cross_entropy", input, label, weight)
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, 1e-10, 1.0))
    n = input.shape[axis]
    if soft_label:
        tgt = label
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n
        if weight is not None:
            tgt = tgt * weight
        loss = -torch.sum(tgt * logp, dim=axis)
        return _reduce(loss, reduction)
    if label.ndim == logp.ndim:
        label = label.squeeze(axis)
    picked, valid, safe = _pick(logp, label.long(), axis, ignore_index)
    if label_smoothing > 0:
        smooth = torch.mean(logp, dim=axis)
        picked = (1 - label_smoothing) * picked + label_smoothing * smooth
    loss = -torch.where(valid, picked, torch.zeros_like(picked))
    if weight is not None:
        wv = weight[safe] * valid.to(input.dtype)
        loss = loss * wv
        if reduction == "mean":
            return loss.sum() / torch.clamp(wv.sum(), min=1e-9)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced cross-entropy with ``axis`` kept (size 1), and the
    softmax with ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """The negative log-likelihood of log-probabilities ``input`` at
    integer labels along the last axis, weighted and ignored as
    :func:`cross_entropy`'s hard labels."""
    input, weight = amp_cast("nll_loss", input, weight)
    picked, valid, safe = _pick(input, label.long(), -1, ignore_index)
    loss = -torch.where(valid, picked, torch.zeros_like(picked))
    if weight is not None:
        wv = weight[safe] * valid.to(input.dtype)
        loss = loss * wv
        if reduction == "mean":
            return loss.sum() / torch.clamp(wv.sum(), min=1e-9)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(input.dtype).sum(),
                                        min=1.0)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    input, label = amp_cast("mse_loss", input, label)
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    input, label = amp_cast("l1_loss", input, label)
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    """``0.5 d^2 / delta`` where ``|d| < delta``, else ``|d| - delta / 2``."""
    input, label = amp_cast("smooth_l1_loss", input, label)
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    """``-(y log p + (1 - y) log(1 - p))`` with both logs' arguments
    clipped to ``[1e-12, 1]``, times ``weight``."""
    input, label, weight = amp_cast("bce_loss", input, label, weight)
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, eps, 1.0))
             + (1 - label) * torch.log(torch.clamp(1 - input, eps, 1.0)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The JAX package's stable form: ``max(x, 0) - x y + log1p(exp(-|x|))``,
    or with ``pos_weight`` ``(1 - y) x + ((pw - 1) y + 1) (max(-x, 0) +
    log1p(exp(-|x|)))``; times ``weight``."""
    x, y, weight, pos_weight = amp_cast("bce_logits_loss", logit, label,
                                        weight, pos_weight)
    tail = torch.log1p(torch.exp(-torch.abs(x)))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * y + 1
        loss = (1 - y) * x + log_w * (torch.clamp(-x, min=0) + tail)
    else:
        loss = torch.clamp(x, min=0) - x * y + tail
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    """``y (log y - x)`` where ``y > 0``, else 0; ``batchmean`` divides
    the sum by the batch size."""
    input, label = amp_cast("kl_div", input, label)
    loss = torch.where(label > 0, label * (torch.log(label) - input),
                       torch.zeros_like(input))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    """``max(0, -y (a - b) + margin)``."""
    input, other, label = amp_cast("margin_ranking_loss", input, other,
                                   label)
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)
