"""Functional ops of ``paddle.nn.functional`` with Paddle's arguments
and semantics: the port of ``paddle_tpu/ops/nn_ops.py`` (activations,
``linear``, ``embedding``, dropout, the convolutions and pools, the
norms, attention, the losses of ``nn_ops.py:897-1118``, ``one_hot`` /
``label_smooth``, ``unfold``, ``interpolate``, ``pixel_shuffle``,
``temporal_shift``) and of ``paddle_tpu/ops/nn_extra.py`` (the other
losses, ``ctc_loss``, ``sequence_mask``, ``gather_tree``,
``affine_grid`` / ``grid_sample``, ``sparse_attention``, the unpools,
``fold``, the transposed 1-d and 3-d convolutions and the rest).

The ops that the JAX dispatcher casts under ``amp.auto_cast`` ask
``amp_cast`` under the JAX op's name before they run (see
``amp/auto_cast.py``). Dropout draws its key from the threefry
generator (``core/random.py``) and runs the dropout kernel on the card
(``kernels/dropout.py``); no key is drawn where nothing is dropped.
``rrelu`` and ``gumbel_softmax`` draw threefry uniforms as the JAX
package's do, bit for bit.

Layouts: the channel-last forms (``NLC``, ``NHWC``, ``NDHWC``) move the
channels to axis 1, run the channel-first op and move them back.
Padding takes every form of the JAX package (``SAME`` / ``VALID``, an
int, one per spatial axis, two per spatial axis, or pairs with zeros on
the batch and channel axes); uneven pads go into one ``F.pad`` of the
input ahead of the op. The convolutions and pools are PyTorch's (cuDNN
on the card), as the JAX package leaves them to XLA: no TPU kernel of
the JAX package computes them. ``interpolate`` is ``jax.image.resize``:
half-pixel sampling, the triangle (linear) and Keys cubic kernels,
widened when downsampling (antialiasing), whatever ``align_corners``
says, as the JAX package ignores it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_cast
from ..core import dtypes as _dt
from ..core import random as _rng
from ..core import threefry as _tf
from ..core.tensor import to_tensor_arg
from ..kernels import dropout as _dropout
from ..ops.creation import one_hot  # noqa: F401 - Paddle's F.one_hot
from ..ops.manipulation import pad  # noqa: F401 - Paddle's F.pad

__all__ = [
    # activations
    "relu", "relu6", "relu_", "sigmoid", "tanh", "tanh_", "silu", "swish",
    "mish", "tanhshrink", "softsign", "selu", "selu_", "gelu",
    "leaky_relu", "elu", "elu_", "celu", "hardtanh", "hardsigmoid",
    "hardswish", "hardshrink", "softshrink", "softplus",
    "thresholded_relu", "prelu", "rrelu", "softmax", "softmax_",
    "log_softmax", "log_sigmoid", "glu", "maxout", "gumbel_softmax",
    # linear, embedding, dropout
    "linear", "bilinear", "embedding", "one_hot", "label_smooth", "dropout",
    "dropout2d", "dropout3d", "alpha_dropout",
    # convolutions, pools, shapes
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d", "pad", "zeropad2d", "unfold", "fold",
    "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "temporal_shift", "affine_grid", "grid_sample",
    "diag_embed", "sequence_mask", "gather_tree",
    # norms and attention
    "batch_norm", "layer_norm", "instance_norm", "group_norm", "normalize",
    "local_response_norm", "cosine_similarity", "pairwise_distance",
    "scaled_dot_product_attention", "sdpa", "sparse_attention",
    # losses
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "sigmoid_focal_loss", "square_error_cost", "log_loss", "dice_loss",
    "soft_margin_loss", "hinge_embedding_loss", "cosine_embedding_loss",
    "multi_label_soft_margin_loss", "multi_margin_loss",
    "triplet_margin_loss", "triplet_margin_with_distance_loss",
    "npair_loss", "ctc_loss", "margin_cross_entropy",
    "class_center_sample", "hsigmoid_loss"]


# ------------------------------------------------------------ activations --


def relu(x, name=None):
    return F.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return x * torch.sigmoid(x)


swish = silu


def _softplus(x):
    """``jax.nn.softplus``: ``log1p(exp(-|x|)) + max(x, 0)``."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softsign(x, name=None):
    return x / (torch.abs(x) + 1)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def selu(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def gelu(x, approximate: bool = False, name=None):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default, which the GPT model uses)."""
    x, = amp_cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def celu(x, alpha=1.0, name=None):
    return torch.clamp(x, min=0) + alpha * torch.expm1(
        torch.clamp(x, max=0) / alpha)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def prelu(x, weight, data_format="NCHW", name=None):
    """A per-channel slope (axis 1) when ``weight`` has more than one
    entry, as the JAX package's (which ignores ``data_format``)."""
    w = weight
    if w.ndim == 1 and w.shape[0] > 1 and x.ndim > 1:
        w = w.reshape([1, -1] + [1] * (x.ndim - 2))
    return torch.where(x >= 0, x, w * x)


def _inplace(x, out):
    """Paddle's in-place activations: x takes ``out``'s values."""
    with torch.no_grad():
        x.copy_(out)
    return x


def relu_(x, name=None):
    return _inplace(x, relu(x))


def tanh_(x, name=None):
    return _inplace(x, tanh(x))


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, elu(x, alpha))


def selu_(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA, name=None):
    return _inplace(x, selu(x, scale, alpha))


def _uniform(shape, lo, hi, device):
    """``jax.random.uniform(key, shape, float32, lo, hi)`` from the next
    threefry key: the JAX package's draw, bit for bit."""
    key = _rng.next_key().to(device)
    floats = _tf._unit_floats(_tf.random_bits(key, list(shape)))
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Leaky ReLU with a slope per element drawn from ``U[lower,
    upper]`` in training, their mean in eval."""
    if not training:
        slope = (lower + upper) / 2.0
        return torch.where(x >= 0, x, slope * x)
    a = _uniform(x.shape, lower, upper, x.device).to(x.dtype)
    return torch.where(x >= 0, x, a * x)


def softmax(x, axis: int = -1, dtype=None, name=None):
    """Softmax over ``axis`` (``jax.nn.softmax``), in x's dtype."""
    x, = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(_dt.convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, name=None):
    return _inplace(x, softmax(x, axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(_dt.convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def log_sigmoid(x, name=None):
    return -_softplus(-x)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis] //= groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` in float32 with Gumbel noise
    ``g`` from a threefry uniform on ``[1e-20, 1)``; ``hard`` gives the
    one-hot of the argmax with the soft gradient (straight-through)."""
    u = _uniform(x.shape, 1e-20, 1.0, x.device)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x.float() + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y.to(x.dtype)


# --------------------------------------------- linear, embedding, dropout --


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight. It runs
    as one GEMM on the weight's transposed view (no copy) with the bias
    added in the GEMM's epilogue: in bf16 the sum rounds once, where the
    JAX form rounds the product and then the sum."""
    x, weight, bias = amp_cast("linear" if bias is not None
                               else "linear_nobias", x, weight, bias)
    return F.linear(x, weight.t(), bias)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n] @ weight[o] @ x2[n] + bias``."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out.to(x1.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids x; ids equal to ``padding_idx``
    (negative: from the end) look up exact zeros, with no gradient to
    that row."""
    x = to_tensor_arg(x)
    if padding_idx is None:
        weight, = amp_cast("embedding", weight)
        return F.embedding(x, weight)
    weight, = amp_cast("embedding_pad", weight)
    if padding_idx < 0:
        padding_idx += weight.shape[0]
    out = F.embedding(x, weight)
    return torch.where((x == padding_idx)[..., None], out.new_zeros(()), out)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon / C`` (C the last axis; the JAX
    package takes no prior distribution, and neither does this)."""
    return (1 - epsilon) * label + epsilon / label.shape[-1]


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


# ------------------------------------------------ layouts and padding --


_CHANNEL_LAST = ("NLC", "NWC", "NHWC", "NDHWC")


def _first(x, data_format):
    """x with its channels on axis 1 (a channel-last layout moved)."""
    if data_format in _CHANNEL_LAST:
        return torch.movedim(x, -1, 1)
    return x


def _back(out, data_format):
    if data_format in _CHANNEL_LAST:
        return torch.movedim(out, 1, -1)
    return out


def _ntuple(v, n):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * n


def _pair(v):
    return _ntuple(v, 2)


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's ``SAME``: ``ceil(n / stride)`` outputs, the total pad
    ``max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)`` split
    with the odd element on the high side."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pads(padding, sizes, kernel, stride, dilation):
    """``(lo, hi)`` pads per spatial axis for Paddle's padding spec."""
    nd = len(sizes)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"padding {padding!r}")
        return _same_pads(sizes, kernel, stride, dilation)
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        for p in padding[:-nd]:
            if list(p) != [0, 0]:
                raise ValueError(f"padding on the batch/channel axes must "
                                 f"be 0, got {padding}")
        return [(int(p[0]), int(p[1])) for p in padding[-nd:]]
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def _pad_input(x, pads, value=0.0):
    """``(x, padding)`` for a torch op: symmetric pads stay the op's
    own; uneven ones go into one ``F.pad`` of x ahead of it (with
    ``value``), and the op pads nothing."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value), (0,) * len(pads)


# ------------------------------------------------------------ convolutions --


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, nd):
    x, weight, bias = amp_cast(f"conv{nd}d", x, weight, bias)
    x = _first(x, data_format)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    x, pad = _pad_input(x, _pads(padding, x.shape[2:], weight.shape[2:],
                                 stride, dilation))
    out = _CONV[nd](x, weight, None, stride, pad, dilation, groups)
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return _back(out.to(x.dtype), data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, weight ``[out, in / groups, kh, kw]``; the
    output keeps x's dtype."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       groups, dilation, data_format, nd, name):
    """The JAX package's transposed convolution (the input dilated by
    ``stride``, the kernel flipped, pads ``d (k - 1) - lo`` and ``d (k -
    1) - hi + output_padding``): torch's unpadded transposed convolution
    cut to ``[lo, full - hi + output_padding)`` (zeros past its end).
    ``SAME`` pads ``(k - 1) // 2`` on both sides; weight ``[in, out /
    groups, *k]``."""
    x, weight, bias = amp_cast(name, x, weight, bias)
    x = _first(x, data_format)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    out_pad = _ntuple(output_padding, nd)
    ks = weight.shape[2:]
    if isinstance(padding, str):
        pads = ([((k - 1) // 2,) * 2 for k in ks]
                if padding.upper() == "SAME" else [(0, 0)] * nd)
    else:
        pads = _pads(padding, x.shape[2:], ks, stride, dilation)
    full = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    extra = [max(0, op - hi) for op, (_, hi) in zip(out_pad, pads)]
    if any(extra):
        full = F.pad(full, [p for e in reversed(extra) for p in (0, e)])
    index = [slice(None), slice(None)]
    for i, ((lo, hi), op) in enumerate(zip(pads, out_pad)):
        n = full.shape[2 + i] - extra[i]
        index.append(slice(lo, n - hi + op))
    out = full[tuple(index)]
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return _back(out.to(x.dtype), data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, data_format,
                              2, "conv2d_transpose")


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """The JAX package's: the 2-D form on a unit height (the layout
    argument is ignored there, and here)."""
    first = lambda v: v if isinstance(v, int) else v[0]  # noqa: E731
    pad2 = padding if isinstance(padding, str) else (0, first(padding))
    out = conv2d_transpose(x.unsqueeze(2), weight.unsqueeze(2), bias,
                           (1, first(stride)), pad2,
                           (0, first(output_padding)), groups,
                           (1, first(dilation)))
    return out.squeeze(2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """A string ``padding`` pads nothing, as the JAX package's."""
    if isinstance(padding, str):
        padding = 0
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, "NCDHW", 3,
                              "conv3d_transpose")


# ------------------------------------------------------------------ pools --


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _ceil_pads(pads, sizes, ksize, stride):
    """The high pads grown so that a ragged edge gives one more window,
    whose start must lie within the input and its low pad (Paddle's and
    torch's ceil-mode rule)."""
    out = []
    for (lo, hi), n, k, s in zip(pads, sizes, ksize, stride):
        n_out = -(-(n + lo + hi - k) // s) + 1
        if (n_out - 1) * s >= n + lo:
            n_out -= 1
        out.append((lo, max((n_out - 1) * s + k - n - lo, 0)))
    return out


def _pool(x, ksize, stride, padding, nd, reducer, data_format,
          ceil_mode=False, count_include_pad=True):
    """The JAX package's ``reduce_window`` pooling: max pads with
    ``-inf`` (an integer's least value), the mean divides by the whole
    window with ``count_include_pad`` and an explicit padding (ceil-mode
    growth included), else by the window's elements inside the input."""
    x = _first(x, data_format)
    ksize = _ntuple(ksize, nd)
    stride = _ntuple(stride if stride is not None else ksize, nd)
    string = isinstance(padding, str)
    pads = _pads(padding, x.shape[2:], ksize, stride, (1,) * nd)
    if ceil_mode and not string:
        pads = _ceil_pads(pads, x.shape[2:], ksize, stride)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if reducer == "max":
        low = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        out = _MAXPOOL[nd](F.pad(x, flat, value=low), ksize, stride)
        return _back(out, data_format)
    s = _AVGPOOL[nd](F.pad(x, flat), ksize, stride)
    if not (count_include_pad and not string):
        ones = F.pad(torch.ones_like(x[:1, :1]), flat)
        s = s / _AVGPOOL[nd](ones, ksize, stride)
    return _back(s.to(x.dtype), data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    """As the JAX package's: no ceil mode, no mask."""
    return _pool(x, kernel_size, stride, padding, 1, "max", "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max pooling; padding counts as ``-inf`` (an integer input's
    least value), as in the JAX package, whose string paddings take no
    ceil mode. ``return_mask`` also gives each output's flat ``h * W +
    w`` offset in its input plane (the first of equal maxima), the
    format ``max_unpool2d`` takes: NCHW with symmetric explicit pads."""
    if return_mask:
        return _max_pool2d_with_mask(x, kernel_size, stride, padding,
                                     data_format, ceil_mode)
    return _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                 ceil_mode)


def _max_pool2d_with_mask(x, kernel_size, stride, padding, data_format,
                          ceil_mode):
    if data_format != "NCHW":
        raise NotImplementedError("return_mask supports NCHW")
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else k)
    if isinstance(padding, str):
        if padding.upper() != "VALID":
            raise NotImplementedError(
                "return_mask with padding='SAME' (use explicit padding)")
        p = (0, 0)
    else:
        p = _pair(padding)
    out, mask = F.max_pool2d(x, k, s, p, ceil_mode=ceil_mode,
                             return_indices=True)
    return out, mask.to(torch.int32)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "max", data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", "NCL",
                 count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 ceil_mode, count_include_pad=not exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the windows ``[floor(i * n / out), ceil((i + 1) * n /
    out))`` of each axis: the JAX package's strided average where the
    output size divides the input and its averaging-matrix einsum
    elsewhere. Sums in float32 for any input dtype."""
    x = _first(x, data_format)
    return _back(F.adaptive_avg_pool2d(x, _pair(output_size)), data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return F.adaptive_avg_pool1d(x, int(output_size))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    if data_format != "NCDHW":
        raise NotImplementedError("adaptive_avg_pool3d supports NCDHW")
    return F.adaptive_avg_pool3d(x, _ntuple(output_size, 3))


def _adaptive_max(x, output_size, nd):
    out = _ntuple(output_size, nd)
    sizes = x.shape[2:]
    if any(n % o for n, o in zip(sizes, out)):
        raise NotImplementedError(f"non-divisible adaptive max pool "
                                  f"({list(sizes)} to {list(out)})")
    k = tuple(n // o for n, o in zip(sizes, out))
    return _MAXPOOL[nd](x, k, k)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 3)


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, nd):
    """Pooled values written back at their flat offsets in each (N, C)
    plane (the mask ``max_pool2d(return_mask=True)`` gives)."""
    k = _ntuple(kernel_size, nd)
    s = _ntuple(stride or k, nd)
    p = _ntuple(padding, nd)
    if output_size is None:
        size = tuple((x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                     for i in range(nd))
    else:
        size = tuple(int(v) for v in output_size[-nd:])
    n, c = x.shape[:2]
    out = x.new_zeros((n, c, math.prod(size)))
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape((n, c) + size)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 3)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """``[left, right, top, bottom]`` zeros."""
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C * kh * kw, L]`` (C the slowest)."""
    return F.unfold(x, _pair(kernel_sizes), _pair(dilations),
                    _pair(paddings), _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, ``unfold``'s adjoint: ``[N, C * kh * kw, L]`` summed back
    into ``[N, C, H, W]``."""
    return F.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                  _pair(dilations), _pair(paddings), _pair(strides))


# ------------------------------------------------------------- resampling --


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _triangle(t):
    return torch.clamp(1 - torch.abs(t), min=0)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image``'s weight matrix ``[n_in, n_out]`` (scale ``n_out /
    n_in``, no translation, antialiased), in float32 as JAX computes it."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    t = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(t)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), w / torch.where(total != 0, total,
                                          torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, size, method):
    """``jax.image.resize(x, x.shape[:2] + size, method)`` on the
    trailing axes of a channel-first x."""
    for i, n_out in enumerate(size):
        ax = 2 + i
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if method == "nearest":
            src = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * n_in / n_out).long()
            x = torch.index_select(x, ax, src)
            continue
        w = _resize_weights(n_in, n_out, _keys_cubic if method == "cubic"
                            else _triangle, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([ax], [0])), -1, ax)
    return x


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """``jax.image.resize`` to ``size`` (or ``int(n * scale_factor)``):
    ``nearest``, ``linear`` / ``bilinear`` / ``trilinear`` / ``area``
    (the triangle kernel) and ``bicubic`` (Keys cubic). The JAX package
    ignores ``align_corners`` and ``align_mode``; so does this."""
    x = _first(x, data_format)
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * (x.ndim - 2)
        size = [int(s * f) for s, f in zip(x.shape[2:], scale_factor)]
    elif isinstance(size, torch.Tensor):
        size = [int(v) for v in size.tolist()]
    else:
        size = [int(v.item()) if isinstance(v, torch.Tensor) else int(v)
                for v in size]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    return _back(_resize(x, size, method).to(x.dtype), data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[N, C r^2, H, W]`` to ``[N, C, H r, W r]`` (the JAX package
    reads every input as NCHW)."""
    return F.pixel_shuffle(x, int(upscale_factor))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    x = _first(x, "NHWC" if data_format == "NHWC" else "NCHW")
    out = F.pixel_unshuffle(x, int(downscale_factor))
    return _back(out, "NHWC" if data_format == "NHWC" else "NCHW")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    x = _first(x, "NHWC" if data_format == "NHWC" else "NCHW")
    n, c = x.shape[:2]
    out = x.reshape(n, groups, c // groups, *x.shape[2:]).transpose(
        1, 2).reshape(x.shape)
    return _back(out, "NHWC" if data_format == "NHWC" else "NCHW")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """Shift a ``shift_ratio`` of the channels one segment back and as
    many forward (zeros enter), within each group of ``seg_num``."""
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold_c = int(c * shift_ratio)
    left = torch.cat([xr[:, 1:, :fold_c],
                      torch.zeros_like(xr[:, :1, :fold_c])], dim=1)
    right = torch.cat([torch.zeros_like(xr[:, :1, fold_c:2 * fold_c]),
                       xr[:, :-1, fold_c:2 * fold_c]], dim=1)
    return torch.cat([left, right, xr[:, :, 2 * fold_c:]],
                     dim=2).reshape(nt, c, h, w)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, H, W, 2]`` sampling coordinates (x, y) in ``[-1, 1]`` from
    ``theta [N, 2, 3]``."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = [int(v) for v in out_shape.tolist()]
    _, _, h, w = out_shape
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
    gy, gx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base,
                        theta.float()).to(theta.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x ``[N, C, H, W]`` at ``grid [N, Hg, Wg, 2]``: the JAX
    package's bilinear or nearest (round half to even) reads, zeros
    outside the input (``border`` clamps the reads and keeps them)."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    batch = torch.arange(n, device=x.device)[:, None, None]

    def fetch(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        if padding_mode == "border":
            inb = torch.ones_like(inb)
        vals = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.movedim(vals, -1, 1) * inb[:, None].to(x.dtype)

    if mode == "nearest":
        return fetch(torch.round(fx).long(), torch.round(fy).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    wx = (fx - x0).to(x.dtype)[:, None]
    wy = (fy - y0).to(x.dtype)[:, None]
    return (fetch(x0, y0) * (1 - wx) * (1 - wy)
            + fetch(x0 + 1, y0) * wx * (1 - wy)
            + fetch(x0, y0 + 1) * (1 - wx) * wy
            + fetch(x0 + 1, y0 + 1) * wx * wy)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    return torch.diag_embed(input, offset, dim1, dim2)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is below the length
    (``maxlen`` defaults to the longest: one host read)."""
    x = to_tensor_arg(x)
    if maxlen is None:
        maxlen = int(x.max().item())
    r = torch.arange(int(maxlen), device=x.device)
    return (r < x[..., None]).to(_dt.convert_dtype(dtype))


def gather_tree(ids, parents, name=None):
    """Backtrace beam-search chains: ids / parents ``[T, B, beam]`` to
    each final beam's full sequence."""
    T, B, W = ids.shape
    beam = torch.arange(W, device=ids.device).expand(B, W)
    outs = []
    for t in range(T - 1, -1, -1):
        outs.append(torch.gather(ids[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam)
    return torch.stack(outs[::-1])


# ------------------------------------------------------ norms, attention --


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalisation over every axis but the channels' (axis 1, or
    the last for a channel-last layout), of an input of any rank.

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
    x = _first(x, data_format if x.ndim > 2 else "NCHW")
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if not use_stats and x.numel() == x.shape[1]:
        out = _batch_norm_one_value(x, running_mean, running_var, weight,
                                    bias, momentum, epsilon)
    else:
        out = F.batch_norm(x, running_mean, running_var, weight, bias,
                           training=not use_stats, momentum=1.0 - momentum,
                           eps=epsilon)
    return _back(out, data_format if x.ndim > 2 else "NCHW")


def _batch_norm_one_value(x, running_mean, running_var, weight, bias,
                          momentum, epsilon):
    """Batch statistics over one value per channel (``[1, C, 1, 1]``),
    which ``F.batch_norm`` refuses: the JAX package's formula as it
    stands, so the output is the bias (0 without one), the batch
    variance 0, and the running variance takes ``0 * n / max(n - 1, 1)``
    with n = 1."""
    axes = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False)
    out = (xf - mean.reshape(shape)) * torch.rsqrt(var + epsilon).reshape(
        shape)
    if weight is not None:
        out = out * weight.reshape(shape) + bias.reshape(shape)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                ((1 - momentum) * mean).to(running_mean.dtype))
            running_var.mul_(momentum).add_(
                ((1 - momentum) * var).to(running_var.dtype))
    return out.to(x.dtype)


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


def _normalized(xf, axes, eps):
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial axes in
    float32; the running statistics are neither read nor updated (as in
    the JAX package)."""
    x, weight, bias = amp_cast("instance_norm", x, weight, bias)
    out = _normalized(x.float(), list(range(2, x.ndim)), eps)
    if weight is not None:
        shape = [1, -1] + [1] * (x.ndim - 2)
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return out.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = amp_cast("group_norm", x, weight, bias)
    xt = _first(x, "NHWC" if data_format == "NHWC" else "NCHW")
    n, c = xt.shape[:2]
    xg = xt.reshape(n, num_groups, c // num_groups, *xt.shape[2:]).float()
    out = _normalized(xg, list(range(2, xg.ndim)), epsilon).reshape(xt.shape)
    if weight is not None:
        shape = [1, c] + [1] * (xt.ndim - 2)
        out = out * weight.reshape(shape) + bias.reshape(shape)
    return _back(out.to(x.dtype), "NHWC" if data_format == "NHWC"
                 else "NCHW")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """Over a window of ``size`` channels around each (zeros past the
    ends), as the JAX package sums it."""
    sq = torch.square(x)
    half, c = size // 2, x.shape[1]
    padded = F.pad(sq, [0, 0] * (x.ndim - 2) + [half, size - half - 1])
    acc = padded[:, 0:c]
    for i in range(1, size):
        acc = acc + padded[:, i:i + c]
    return x / torch.pow(k + alpha * acc / size, beta)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    na = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    nb = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return torch.sum(x1 * x2, dim=axis) / torch.clamp(na * nb, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = (x - y).float() + epsilon
    return torch.linalg.vector_norm(torch.abs(d), ord=p, dim=-1,
                                    keepdim=keepdim).to(x.dtype)


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


sdpa = scaled_dot_product_attention


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention on ``[B, H, S, D]``, dense under the CSR
    mask as the JAX package computes it: the row of each column entry
    comes from the first (batch, head)'s offsets, the logits are scaled
    by ``1 / sqrt(D)`` in q's dtype and masked to -1e30 in float32."""
    q, k, v = query, key, value
    B, H, S, D = q.shape
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) / torch.sqrt(
        torch.tensor(float(D))).to(q.dtype)
    counts = torch.diff(sparse_csr_offset, dim=-1).reshape(-1, S)[0]
    row = torch.repeat_interleave(torch.arange(S, device=q.device),
                                  counts.long())
    cols = sparse_csr_columns.long()
    mask = torch.zeros((B, H, S, S), dtype=torch.bool, device=q.device)
    b = torch.arange(B, device=q.device)[:, None, None]
    h = torch.arange(H, device=q.device)[None, :, None]
    mask[b, h, row[None, None, :cols.shape[-1]], cols] = True
    logits = torch.where(mask, logits.float(), torch.full_like(
        logits, -1e30, dtype=torch.float32))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


# ------------------------------------------------------------------ losses --

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


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label, normalizer = amp_cast("sigmoid_focal_loss", logit, label,
                                        normalizer)
    x, y = logit, label
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def square_error_cost(input, label, name=None):  # noqa: A002
    return torch.square(input - label)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    pf = input.float()
    return (-label * torch.log(pf + epsilon) - (1.0 - label) * torch.log(
        1.0 - pf + epsilon)).to(input.dtype)


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """``1 - (2 |X n Y| + eps) / (|X| + |Y| + eps)`` per sample, averaged;
    ``label`` holds class ids ``[..., 1]``."""
    oh = F.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = torch.sum(input * oh, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(oh, dim=dims)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    loss = torch.log1p(torch.exp(-label * input.float()))
    return _reduce(loss, reduction).to(input.dtype)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    xf = input.float()
    loss = torch.where(label == 1.0, xf, torch.clamp(margin - xf, min=0.0))
    return _reduce(loss, reduction).to(input.dtype)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b = input1.float(), input2.float()
    cos = torch.sum(a * b, -1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1.0 - cos, torch.clamp(cos - margin,
                                                          min=0.0))
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    xf = input.float()
    loss = -(label * log_sigmoid(xf) + (1 - label) * log_sigmoid(-xf))
    if weight is not None:
        loss = loss * weight
    return _reduce(torch.mean(loss, dim=-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean", name=None):
    xf = input.float()
    c = xf.shape[1]
    y = label.long()
    correct = torch.take_along_dim(xf, y[:, None], 1)
    m = torch.clamp(margin - correct + xf, min=0.0) ** p
    if weight is not None:
        m = m * weight[y][:, None]
    oh = F.one_hot(y, c).float()
    return _reduce(torch.sum(m * (1 - oh), dim=1) / c, reduction)


def _p_dist(u, v, p, eps):
    return torch.linalg.vector_norm((u - v).float() + eps, ord=p, dim=-1)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _p_dist(input, positive, p, epsilon)
    dn = _p_dist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _p_dist(positive, negative, p, epsilon))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Softmax cross-entropy over ``anchor @ positive^T`` toward the
    same-label rows, plus ``l2_reg`` on the embeddings."""
    af, pf = anchor.float(), positive.float()
    reg = l2_reg * (torch.mean(torch.sum(af * af, 1))
                    + torch.mean(torch.sum(pf * pf, 1))) * 0.25 * 2
    same = (labels[:, None] == labels[None, :]).float()
    tgt = same / torch.clamp(same.sum(1, keepdim=True), min=1.0)
    logp = torch.log_softmax(af @ pf.t(), dim=1)
    return -torch.mean(torch.sum(tgt * logp, dim=1)) + reg


_CTC_NEG = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over unnormalised logits ``[T, B, C]`` (softmax inside, as
    Paddle's warpctc) and padded ``labels [B, L]``: the alpha recursion
    over the blank-interleaved labels in log space, in float32, a loop
    over time as the JAX ``lax.scan``."""
    T, B, _ = log_probs.shape
    L = labels.shape[1]
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    dev = lp.device
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    skip_ok = torch.zeros((B, S), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != blank)
    lab_len = label_lengths.long().to(dev)
    neg = torch.full((B, S), _CTC_NEG, device=dev)
    bidx = torch.arange(B, device=dev)
    alpha = neg.clone()
    alpha[:, 0] = lp[0, bidx, ext[:, 0]]
    alpha[:, 1] = torch.where(lab_len > 0, lp[0, bidx, ext[:, 1]],
                              torch.full_like(alpha[:, 1], _CTC_NEG))
    alphas = [alpha]
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg[:, :2], alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip_ok, prev2, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        alpha = merged + torch.gather(lp[t], 1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    t_idx = torch.clamp(input_lengths.long().to(dev) - 1, 0, T - 1)
    a_t = alphas[t_idx, bidx]
    s_last = 2 * lab_len
    s_prev = torch.clamp(s_last - 1, min=0)
    ll = torch.logaddexp(
        torch.gather(a_t, 1, s_last[:, None])[:, 0],
        torch.where(lab_len > 0, torch.gather(a_t, 1, s_prev[:, None])[:, 0],
                    torch.full_like(a_t[:, 0], _CTC_NEG)))
    loss = -ll
    if norm_by_times:
        loss = loss / torch.clamp(input_lengths.float().to(dev), min=1.0)
    return _reduce(loss, reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family margins: the target cosine ``cos(t)`` becomes
    ``cos(margin1 * t + margin2) - margin3`` before the scaled softmax
    cross-entropy (one device: the classes are not sharded)."""
    lf = torch.clamp(logits.float(), -1.0, 1.0)
    y = label.long()
    theta = torch.arccos(torch.take_along_dim(lf, y[:, None], 1)[:, 0])
    target = torch.cos(margin1 * theta + margin2) - margin3
    oh = F.one_hot(y, lf.shape[1]).float()
    adj = lf * (1 - oh) + target[:, None] * oh
    logp = torch.log_softmax(scale * adj, dim=1)
    loss = _reduce(-torch.take_along_dim(logp, y[:, None], 1)[:, 0],
                   reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """Every positive class and random negatives up to ``num_samples``
    (drawn by the current device's torch generator): ``(remapped labels,
    sampled classes)``."""
    y = label.reshape(-1).long()
    pos = torch.unique(y)
    if pos.numel() >= num_samples:
        sampled = pos
    else:
        rest = torch.ones(num_classes, dtype=torch.bool, device=y.device)
        rest[pos] = False
        rest = torch.nonzero(rest)[:, 0]
        perm = torch.randperm(rest.numel(), device=y.device,
                              generator=_rng.generator(y.device))
        sampled = torch.sort(torch.cat(
            [pos, rest[perm[:num_samples - pos.numel()]]])).values
    remap = torch.full((num_classes,), -1, dtype=torch.long, device=y.device)
    remap[sampled] = torch.arange(sampled.numel(), device=y.device)
    return remap[y].reshape(label.shape), sampled


def _default_tree(labels, num_classes):
    """Path nodes and right-child codes of the complete binary tree (class
    c is leaf ``c + num_classes - 1``), -1 past a path's end."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    tab = -np.ones((len(labels), depth), np.int64)
    code = np.zeros((len(labels), depth), np.float32)
    for i, c in enumerate(labels):
        node, path = int(c) + num_classes - 1, []
        while node > 0:
            parent = (node - 1) // 2
            path.append((parent, float(node == 2 * parent + 2)))
            node = parent
        for j, (p, bit) in enumerate(reversed(path)):
            tab[i, j], code[i, j] = p, bit
    return tab, code


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: the binary cross-entropy of each node's
    logit along the class's root-to-leaf path, summed (``[N, 1]``). The
    default tree's paths are built on the host from the labels, as in
    the JAX package; custom trees come as ``path_table`` / ``path_code``."""
    dev = input.device
    if path_table is None:
        tab, code = _default_tree(label.reshape(-1).tolist(), num_classes)
        tab = torch.as_tensor(tab, device=dev)
        code = torch.as_tensor(code, device=dev)
    else:
        tab, code = path_table.long(), path_code.float()
    mask = (tab >= 0).float()
    tab = torch.clamp(tab, min=0)
    logits = torch.einsum("ndh,nh->nd", weight[tab].float(), input.float())
    if bias is not None:
        logits = logits + bias.reshape(-1)[tab].float()
    bce = torch.clamp(logits, min=0) - logits * code + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return torch.sum(bce * mask, dim=1, keepdim=True).to(input.dtype)
