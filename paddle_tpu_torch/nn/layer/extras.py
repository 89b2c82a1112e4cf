"""The layer tail (counterpart of ``paddle_tpu/nn/layer/extras.py``): the
loss layers of ``nn_extra``'s losses, the adaptive 1-d / 3-d pools and
the unpools, ``Fold`` / ``Unfold``, ``Conv1DTranspose`` /
``Conv3DTranspose``, ``LogSigmoid`` / ``RReLU`` / ``Softmax2D``,
``PairwiseDistance``, ``LayerDict``, and beam search
(``BeamSearchDecoder`` with ``dynamic_decode``).

``dynamic_decode`` keeps the JAX package's loop as it stands: it starts
from a ``[1, 1]`` start token, and each step reorders the states of
every row by row 0's beam sources, so it is right at batch 1 only
(ROADMAP queue C). The beams' scores are float64 on the host, as there;
the cell runs on its device.
"""
from __future__ import annotations

import collections

import numpy as np

from ...core.tensor import to_tensor
from .. import functional as F
from .layers import Layer, create_parameter, functional_layer

__all__ = ["CTCLoss", "CosineEmbeddingLoss", "HingeEmbeddingLoss",
           "SoftMarginLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "TripletMarginLoss", "TripletMarginWithDistanceLoss",
           "HSigmoidLoss", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
           "ChannelShuffle", "PixelUnshuffle", "Fold", "Unfold",
           "Conv1DTranspose", "Conv3DTranspose", "LogSigmoid", "RReLU",
           "Softmax2D", "PairwiseDistance", "LayerDict",
           "BeamSearchDecoder", "dynamic_decode"]


def _ctc(fn, inputs, values):
    """``CTCLoss(...)(log_probs, labels, input_lengths, label_lengths,
    norm_by_times=False)``."""
    return fn(*inputs[:4], **values, norm_by_times=(
        inputs[4] if len(inputs) > 4 else False))


CTCLoss = functional_layer("CTCLoss", F.ctc_loss, _ctc, blank=0,
                           reduction="mean")
CosineEmbeddingLoss = functional_layer(
    "CosineEmbeddingLoss", F.cosine_embedding_loss, margin=0.0,
    reduction="mean")
HingeEmbeddingLoss = functional_layer(
    "HingeEmbeddingLoss", F.hinge_embedding_loss, margin=1.0,
    reduction="mean")
SoftMarginLoss = functional_layer("SoftMarginLoss", F.soft_margin_loss,
                                  reduction="mean")
MultiLabelSoftMarginLoss = functional_layer(
    "MultiLabelSoftMarginLoss", F.multi_label_soft_margin_loss,
    weight=None, reduction="mean")
MultiMarginLoss = functional_layer("MultiMarginLoss", F.multi_margin_loss,
                                   p=1, margin=1.0, weight=None,
                                   reduction="mean")
TripletMarginLoss = functional_layer(
    "TripletMarginLoss", F.triplet_margin_loss, margin=1.0, p=2.0,
    epsilon=1e-6, swap=False, reduction="mean")
TripletMarginWithDistanceLoss = functional_layer(
    "TripletMarginWithDistanceLoss", F.triplet_margin_with_distance_loss,
    distance_function=None, margin=1.0, swap=False, reduction="mean")
AdaptiveAvgPool3D = functional_layer(
    "AdaptiveAvgPool3D", F.adaptive_avg_pool3d, output_size=None,
    data_format="NCDHW")
AdaptiveMaxPool1D = functional_layer(
    "AdaptiveMaxPool1D", F.adaptive_max_pool1d, output_size=None,
    return_mask=False)
AdaptiveMaxPool3D = functional_layer(
    "AdaptiveMaxPool3D", F.adaptive_max_pool3d, output_size=None,
    return_mask=False)
MaxUnPool1D = functional_layer(
    "MaxUnPool1D", F.max_unpool1d, kernel_size=None, stride=None, padding=0,
    data_format="NCL", output_size=None)
MaxUnPool2D = functional_layer(
    "MaxUnPool2D", F.max_unpool2d, kernel_size=None, stride=None, padding=0,
    data_format="NCHW", output_size=None)
MaxUnPool3D = functional_layer(
    "MaxUnPool3D", F.max_unpool3d, kernel_size=None, stride=None, padding=0,
    data_format="NCDHW", output_size=None)
ChannelShuffle = functional_layer("ChannelShuffle", F.channel_shuffle,
                                  groups=None, data_format="NCHW")
PixelUnshuffle = functional_layer("PixelUnshuffle", F.pixel_unshuffle,
                                  downscale_factor=None, data_format="NCHW")
Fold = functional_layer("Fold", F.fold, output_sizes=None, kernel_sizes=None,
                        strides=1, paddings=0, dilations=1)
Unfold = functional_layer("Unfold", F.unfold, kernel_sizes=None, strides=1,
                          paddings=0, dilations=1)
PairwiseDistance = functional_layer("PairwiseDistance", F.pairwise_distance,
                                    p=2.0, epsilon=1e-6, keepdim=False)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over ``num_classes`` leaves: weight
    ``[num_classes - 1, feature_size]`` and bias ``[num_classes - 1]``
    (Xavier-normal and zeros, free-standing parameters as in the JAX
    package)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = create_parameter([num_classes - 1, feature_size])
        self.bias = (None if bias_attr is False
                     else create_parameter([num_classes - 1], is_bias=True))

    def forward(self, input, label, path_table=None,  # noqa: A002
                path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)


class _ConvTransposeNd(Layer):
    """Weight ``[in, out / groups, *k]`` and bias ``[out]``, Xavier-normal
    and zeros (the JAX layer's free-standing parameters)."""

    def __init__(self, fn, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, weight_attr=None, bias_attr=None):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        self._fn = fn
        self._args = dict(stride=stride, padding=padding,
                          output_padding=output_padding, dilation=dilation,
                          groups=groups)
        self.weight = create_parameter(
            [in_channels, out_channels // groups, *kernel_size])
        self.bias = (None if bias_attr is False
                     else create_parameter([out_channels], is_bias=True))

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, bias=self.bias, **self._args)


class Conv1DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(F.conv1d_transpose, in_channels, out_channels,
                         kernel_size, 1, stride, padding, output_padding,
                         dilation, groups, weight_attr, bias_attr)


class Conv3DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(F.conv3d_transpose, in_channels, out_channels,
                         kernel_size, 3, stride, padding, output_padding,
                         dilation, groups, weight_attr, bias_attr)


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Softmax2D(Layer):
    """Softmax over the channels of NCHW (axis -3)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        if isinstance(sublayers, (dict, collections.OrderedDict)):
            sublayers = sublayers.items()
        for k, v in sublayers:
            self.add_sublayer(k, v)
        return self


# ----------------------------------------------------------- beam search --


class BeamSearchDecoder:
    """Beam search over an RNN cell, for :func:`dynamic_decode`: each
    step embeds the tokens (``embedding_fn``), runs the cell, projects
    (``output_fn``) and takes log-softmax."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token, self.end_token = int(start_token), int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn, self.output_fn = embedding_fn, output_fn

    def _logits(self, tok, states):
        inp = to_tensor(np.asarray(tok, np.int64))
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, new_states = self.cell(inp, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        return out, new_states


def _log_softmax_np(out):
    """The last position's log-softmax in float64, on the host."""
    arr = np.asarray(out.detach().cpu().double().numpy())
    if arr.ndim == 3:
        arr = arr[:, -1, :]
    m = arr.max(-1, keepdims=True)
    return (arr - m) - np.log(np.exp(arr - m).sum(-1, keepdims=True))


def dynamic_decode(decoder, inits=None, max_step_num=None, **kwargs):
    """The JAX package's beam loop: the start token, then each step
    expands every beam by every token (a finished beam only by
    ``end_token`` at no cost), keeps the ``beam_size`` best cumulative
    log-probabilities, and stops when every beam has ended or after
    ``max_step_num`` (default 32) steps. Returns ``(ids [B, T, beam],
    scores [B, beam])``."""
    if max_step_num is None:
        max_step_num = 32
    W = decoder.beam_size
    tokens = scores = finished = None
    states, seqs = [inits] * W, []
    for _ in range(max_step_num):
        if tokens is None:
            out, st = decoder._logits(np.array([[decoder.start_token]]),
                                      inits)
            logp = _log_softmax_np(out)
            top = np.argsort(-logp, axis=-1)[:, :W]
            scores = np.take_along_axis(logp, top, -1)
            tokens = top
            states = [st] * W
            finished = tokens == decoder.end_token
            seqs.append(tokens.copy())
            continue
        all_scores, all_states = [], []
        for w in range(W):
            out, st = decoder._logits(tokens[:, w:w + 1], states[w])
            logp = _log_softmax_np(out)
            s = scores[:, w:w + 1] + np.where(finished[:, w:w + 1], 0.0,
                                              logp)
            if finished[:, w].any():
                mask = np.full_like(logp, -np.inf)
                mask[:, decoder.end_token] = 0.0
                s = np.where(finished[:, w:w + 1],
                             scores[:, w:w + 1] + mask, s)
            all_scores.append(s)
            all_states.append(st)
        flat = np.concatenate(all_scores, axis=-1)
        V = flat.shape[-1] // W
        top = np.argsort(-flat, axis=-1)[:, :W]
        beam_src = top // V
        tok = top % V
        scores = np.take_along_axis(flat, top, -1)
        states = [all_states[int(beam_src[0, w])] for w in range(W)]
        finished = np.take_along_axis(finished, beam_src, -1) | (
            tok == decoder.end_token)
        tokens = tok
        seqs.append(tokens.copy())
        if finished.all():
            break
    return to_tensor(np.stack(seqs, axis=1)), to_tensor(scores)
