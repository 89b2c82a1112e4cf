"""The port's ``nn.functional`` tail and layer families against the JAX
package's, on the CPU.

- one parametrised case per functional op of ``nn_ops.py`` /
  ``nn_extra.py`` ported in this slice (activations, convolutions in
  every layout and padding form, pools with ``ceil_mode`` and masks,
  norms of any rank, ``interpolate`` with the JAX package's own
  ``jax.image.resize`` formulas, the vision ops, the losses), float32
  within rtol / atol 1e-5, integers exact;
- the forms that raised ``NotImplementedError`` before this slice:
  channel-last layouts, four-sided padding, ``max_pool2d(return_mask=
  True)`` (its mask feeding ``max_unpool2d``), ``batch_norm`` of 2-d,
  3-d and 5-d inputs, ``Conv2D(padding_mode=...)``;
- each layer family with the JAX layer's weights carried over by name
  (``layer_state_from_jax``): outputs within 1e-5, and the gradients
  of the summed squared output (the input's and every parameter's)
  within 1e-4 relative;
- ``nn.utils``: ``weight_norm`` / ``remove_weight_norm``,
  ``spectral_norm`` (its ``default_rng(0)`` start included), the grad
  clips and the parameter <-> vector packing.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn import layer_state_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(a) for a in x]
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _close(got, want, name, rtol=RTOL, atol=ATOL):
    if isinstance(want, list):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _close(g, w, name, rtol, atol)
        return
    assert tuple(got.shape) == tuple(want.shape), (name, got.shape,
                                                   want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


def _data(seed):
    r = np.random.RandomState(seed)
    f = lambda *s: r.randn(*s).astype("float32")  # noqa: E731
    return {
        "x": f(2, 3, 4, 5), "x1": f(2, 3, 9), "x3": f(1, 2, 4, 5, 6),
        "nhwc": f(2, 4, 5, 3), "h": f(4, 6), "h2": f(4, 6),
        "w2": f(4, 3, 3, 3) * 0.3, "w1": f(4, 3, 3) * 0.3,
        "w3": f(3, 2, 2, 3, 3) * 0.3, "wt": f(3, 4, 3, 3) * 0.3,
        "wt1": f(3, 4, 3) * 0.3, "wt3": f(2, 3, 2, 2, 2) * 0.3,
        "b4": f(4), "b3": f(3), "g3": np.abs(f(3)) + 0.5,
        "prob": 1 / (1 + np.exp(-f(4, 6))),
        "y01": (r.rand(4, 6) > 0.5).astype("float32"),
        "ypm": np.where(r.rand(4) > 0.5, 1.0, -1.0).astype("float32"),
        "cls": r.randint(0, 6, (4,)).astype("int64"),
        "theta": f(2, 2, 3) * 0.5,
        "grid": np.tanh(f(2, 3, 4, 2)),
        "qkv": f(1, 2, 4, 8),
        "emb": f(10, 6), "ids": r.randint(0, 10, (3, 5)).astype("int64"),
    }


CASES = {
    # activations
    **{f"act_{n}": (lambda n: lambda F, d: getattr(F, n)(d["h"]))(n)
       for n in ("relu6", "sigmoid", "tanh", "silu", "swish", "mish",
                 "tanhshrink", "softsign", "selu", "leaky_relu", "elu",
                 "celu", "hardtanh", "hardsigmoid", "hardswish",
                 "hardshrink", "softshrink", "softplus",
                 "thresholded_relu", "log_sigmoid", "log_softmax")},
    "softplus_beta": lambda F, d: F.softplus(d["h"], 2.0, 1.0),
    "rrelu_eval": lambda F, d: F.rrelu(d["h"], training=False),
    "prelu": lambda F, d: F.prelu(d["x"], np.array([0.1, 0.2, 0.3],
                                                   "float32")),
    "glu": lambda F, d: F.glu(d["h"], axis=1),
    "maxout": lambda F, d: F.maxout(d["h"].reshape(4, 6, 1), 3, axis=1),
    "embedding_pad": lambda F, d: F.embedding(d["ids"], d["emb"],
                                              padding_idx=-1),
    "one_hot": lambda F, d: F.one_hot(d["cls"], 6),
    "label_smooth": lambda F, d: F.label_smooth(d["y01"], epsilon=0.2),
    "bilinear": lambda F, d: F.bilinear(d["h"], d["h2"], d["w2"][:, 0, :2,
                                                                  :2]
                                        .repeat(3, 1).repeat(3, 2)[:, :6,
                                                                   :6],
                                        d["b4"]),
    # convolutions
    "conv2d": lambda F, d: F.conv2d(d["x"], d["w2"], d["b4"], 1, 1),
    "conv2d_same": lambda F, d: F.conv2d(d["x"], d["w2"], None, 2, "SAME"),
    "conv2d_4side": lambda F, d: F.conv2d(d["x"], d["w2"], d["b4"], 1,
                                          [1, 0, 2, 1]),
    "conv2d_pairs": lambda F, d: F.conv2d(d["x"], d["w2"], None, 1,
                                          [[2, 0], [1, 1]]),
    "conv2d_nhwc": lambda F, d: F.conv2d(d["nhwc"], d["w2"], d["b4"], 1, 1,
                                         data_format="NHWC"),
    "conv2d_dil_group": lambda F, d: F.conv2d(d["x"], d["w2"][:3, :1], None,
                                              1, 2, 2, 3),
    "conv1d": lambda F, d: F.conv1d(d["x1"], d["w1"], d["b4"], 2, 1),
    "conv1d_nlc": lambda F, d: F.conv1d(d["x1"].transpose(0, 2, 1),
                                        d["w1"], None, 1, "SAME",
                                        data_format="NLC"),
    "conv3d": lambda F, d: F.conv3d(d["x3"], d["w3"], d["b3"], 1, 1),
    "conv2d_transpose": lambda F, d: F.conv2d_transpose(
        d["x"], d["wt"], d["b4"], 2, 1, 1),
    "conv2d_transpose_4side": lambda F, d: F.conv2d_transpose(
        d["x"], d["wt"], None, 2, [1, 0, 0, 2], 1),
    "conv2d_transpose_same": lambda F, d: F.conv2d_transpose(
        d["x"], d["wt"], None, 1, "SAME"),
    "conv1d_transpose": lambda F, d: F.conv1d_transpose(
        d["x1"], d["wt1"], d["b4"], 2, 1, 1),
    "conv3d_transpose": lambda F, d: F.conv3d_transpose(
        d["x3"], d["wt3"], d["b3"], 2, 1),
    # pools
    "max_pool2d_ceil": lambda F, d: F.max_pool2d(d["x"], 2, 2, 0, True),
    "max_pool2d_4side": lambda F, d: F.max_pool2d(d["x"], 3, 2,
                                                  [1, 0, 1, 1]),
    "max_pool2d_nhwc": lambda F, d: F.max_pool2d(d["nhwc"], 2,
                                                 data_format="NHWC"),
    "max_pool2d_same": lambda F, d: F.max_pool2d(d["x"], 3, 2, "SAME"),
    "max_pool2d_mask": lambda F, d: F.max_pool2d(d["x"], 2, 2, 1,
                                                 return_mask=True),
    "max_pool2d_mask_ceil": lambda F, d: F.max_pool2d(
        d["x"], 3, 2, 0, True, return_mask=True),
    "avg_pool2d": lambda F, d: F.avg_pool2d(d["x"], 3, 2, 1),
    "avg_pool2d_incl": lambda F, d: F.avg_pool2d(d["x"], 3, 2, 1, True,
                                                 exclusive=False),
    "avg_pool2d_same": lambda F, d: F.avg_pool2d(d["x"], 2, 2, "SAME"),
    "max_pool1d": lambda F, d: F.max_pool1d(d["x1"], 3, 2, 1),
    "avg_pool1d": lambda F, d: F.avg_pool1d(d["x1"], 2, 2, 1,
                                            exclusive=False),
    "max_pool3d": lambda F, d: F.max_pool3d(d["x3"], 2, 2),
    "avg_pool3d": lambda F, d: F.avg_pool3d(d["x3"], 2, 1, 1),
    "adaptive_avg_pool1d": lambda F, d: F.adaptive_avg_pool1d(d["x1"], 4),
    "adaptive_avg_pool2d": lambda F, d: F.adaptive_avg_pool2d(d["x"],
                                                              [3, 2]),
    "adaptive_avg_pool2d_nhwc": lambda F, d: F.adaptive_avg_pool2d(
        d["nhwc"], 2, data_format="NHWC"),
    "adaptive_avg_pool3d": lambda F, d: F.adaptive_avg_pool3d(d["x3"],
                                                              [2, 3, 4]),
    "adaptive_max_pool1d": lambda F, d: F.adaptive_max_pool1d(d["x1"], 3),
    "adaptive_max_pool2d": lambda F, d: F.adaptive_max_pool2d(
        d["x"][..., :4], 2),
    "adaptive_max_pool3d": lambda F, d: F.adaptive_max_pool3d(d["x3"],
                                                              [2, 5, 3]),
    # norms
    "batch_norm_2d_input": lambda F, d: F.batch_norm(
        d["h"], np.zeros(6, "float32"), np.ones(6, "float32"),
        training=True),
    "batch_norm_5d": lambda F, d: F.batch_norm(
        d["x3"], np.zeros(2, "float32"), np.ones(2, "float32"),
        d["g3"][:2], d["b3"][:2], training=True),
    "batch_norm_nhwc_eval": lambda F, d: F.batch_norm(
        d["nhwc"], d["b3"], d["g3"], d["g3"], d["b3"],
        data_format="NHWC"),
    "instance_norm": lambda F, d: F.instance_norm(d["x"], weight=d["g3"],
                                                  bias=d["b3"]),
    "group_norm": lambda F, d: F.group_norm(d["x"].reshape(2, 6, 2, 5), 3,
                                            weight=np.ones(6, "float32"),
                                            bias=np.zeros(6, "float32")),
    "normalize": lambda F, d: F.normalize(d["h"], 3, 1),
    "local_response_norm": lambda F, d: F.local_response_norm(d["x"], 3),
    "cosine_similarity": lambda F, d: F.cosine_similarity(d["h"], d["h2"]),
    "pairwise_distance": lambda F, d: F.pairwise_distance(d["h"], d["h2"],
                                                          3.0),
    # vision and shapes
    "pad_reflect": lambda F, d: F.pad(d["x"], [1, 2, 2, 1], "reflect"),
    "zeropad2d": lambda F, d: F.zeropad2d(d["x"], [1, 0, 0, 2]),
    "unfold": lambda F, d: F.unfold(d["x"], 2, 1, 1, 1),
    "fold": lambda F, d: F.fold(F.unfold(d["x"], [2, 3], 1, 0, 1), [4, 5],
                                [2, 3]),
    "interp_nearest_up": lambda F, d: F.interpolate(d["x"], [7, 9]),
    "interp_nearest_down": lambda F, d: F.interpolate(d["x"], [3, 2]),
    "interp_bilinear_up": lambda F, d: F.interpolate(
        d["x"], scale_factor=2, mode="bilinear", align_corners=True),
    "interp_bilinear_down": lambda F, d: F.interpolate(d["x"], [3, 3],
                                                       mode="bilinear"),
    "interp_bicubic": lambda F, d: F.interpolate(d["x"], [6, 7],
                                                 mode="bicubic"),
    "interp_linear_1d": lambda F, d: F.interpolate(d["x1"], [13],
                                                   mode="linear"),
    "interp_trilinear": lambda F, d: F.interpolate(d["x3"], [3, 6, 4],
                                                   mode="trilinear"),
    "interp_nhwc": lambda F, d: F.upsample(d["nhwc"], [5, 8],
                                           mode="bilinear",
                                           data_format="NHWC"),
    "pixel_shuffle": lambda F, d: F.pixel_shuffle(
        d["x"].reshape(2, 12, 1, 5), 2),
    "pixel_unshuffle": lambda F, d: F.pixel_unshuffle(d["x"][..., :4], 2),
    "channel_shuffle": lambda F, d: F.channel_shuffle(
        d["x"].reshape(2, 6, 2, 5), 3),
    "temporal_shift": lambda F, d: F.temporal_shift(
        d["x"].reshape(4, 3, 2, 5)[:, :, :, :], 2, 0.34),
    "affine_grid": lambda F, d: F.affine_grid(d["theta"], [2, 3, 4, 5]),
    "affine_grid_noalign": lambda F, d: F.affine_grid(
        d["theta"], [2, 3, 4, 5], align_corners=False),
    "grid_sample": lambda F, d: F.grid_sample(d["x"][:, :, :, :], d["grid"]),
    "grid_sample_nearest": lambda F, d: F.grid_sample(
        d["x"], d["grid"], mode="nearest", align_corners=False),
    "grid_sample_border": lambda F, d: F.grid_sample(
        d["x"], d["grid"] * 1.5, padding_mode="border"),
    "diag_embed": lambda F, d: F.diag_embed(d["h"], 1, 0, 2),
    "sequence_mask": lambda F, d: F.sequence_mask(
        np.array([1, 3, 0], "int64"), 4),
    "gather_tree": lambda F, d: F.gather_tree(
        np.array([[[2, 3]], [[4, 5]], [[6, 7]]], "int64"),
        np.array([[[0, 0]], [[1, 0]], [[1, 1]]], "int64")),
    "sparse_attention": lambda F, d: F.sparse_attention(
        d["qkv"], d["qkv"] * 0.5, d["qkv"],
        np.array([[[0, 1, 3, 4, 6]] * 2], "int32"),
        np.array([[[0, 0, 1, 2, 1, 3]] * 2], "int32")),
    # losses
    "sigmoid_focal_loss": lambda F, d: F.sigmoid_focal_loss(d["h"],
                                                            d["y01"]),
    "sigmoid_focal_loss_norm": lambda F, d: F.sigmoid_focal_loss(
        d["h"], d["y01"], np.array([3.0], "float32"), reduction="mean"),
    "square_error_cost": lambda F, d: F.square_error_cost(d["h"], d["h2"]),
    "log_loss": lambda F, d: F.log_loss(d["prob"], d["y01"]),
    "dice_loss": lambda F, d: F.dice_loss(
        np.exp(d["h"]) / np.exp(d["h"]).sum(-1, keepdims=True),
        d["cls"][:, None]),
    "soft_margin_loss": lambda F, d: F.soft_margin_loss(d["h"][:, 0],
                                                        d["ypm"]),
    "hinge_embedding_loss": lambda F, d: F.hinge_embedding_loss(
        d["h"][:, 0], d["ypm"], reduction="sum"),
    "cosine_embedding_loss": lambda F, d: F.cosine_embedding_loss(
        d["h"], d["h2"], d["ypm"], margin=0.1),
    "multi_label_soft_margin_loss": lambda F, d:
        F.multi_label_soft_margin_loss(d["h"], d["y01"]),
    "multi_margin_loss": lambda F, d: F.multi_margin_loss(d["h"], d["cls"],
                                                          p=2),
    "triplet_margin_loss": lambda F, d: F.triplet_margin_loss(
        d["h"], d["h2"], d["h"] * 0.5, swap=True),
    "npair_loss": lambda F, d: F.npair_loss(d["h"], d["h2"],
                                            d["cls"].astype("float32")),
    "ctc_loss": lambda F, d: F.ctc_loss(
        d["x"].reshape(5, 2, 12), np.array([[1, 2, 2], [3, 0, 0]], "int32"),
        np.array([5, 4], "int64"), np.array([3, 1], "int64")),
    "ctc_loss_norm": lambda F, d: F.ctc_loss(
        d["x"].reshape(5, 2, 12), np.array([[1, 2, 2], [3, 1, 0]], "int32"),
        np.array([5, 5], "int64"), np.array([3, 2], "int64"),
        reduction="none", norm_by_times=True),
    "margin_cross_entropy": lambda F, d: F.margin_cross_entropy(
        np.tanh(d["h"]), d["cls"], return_softmax=True),
    "hsigmoid_loss": lambda F, d: F.hsigmoid_loss(
        d["h"], d["cls"], 6, d["emb"][:5], d["b4"][:1].repeat(5)),
}


class _Tensors:
    """``F`` with every numpy argument made the package's tensor first,
    so that the cases shape their inputs with numpy."""

    def __init__(self, p, F):
        self._p, self._F = p, F

    def _arg(self, a):
        if isinstance(a, np.ndarray):
            return self._p.to_tensor(a)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [self._p.to_tensor(x) for x in a]
        return a

    def __getattr__(self, name):
        fn = getattr(self._F, name)
        return lambda *a, **k: fn(*[self._arg(x) for x in a],
                                  **{n: self._arg(v) for n, v in k.items()})


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_matches_jax(name):
    d = _data(zlib.crc32(name.encode()) % 1000)
    want = _np(CASES[name](_Tensors(jp, JF), d))
    got = _np(CASES[name](_Tensors(tp, TF), d))
    _close(got, want, name)


def test_max_pool_mask_feeds_max_unpool():
    """``max_pool2d(return_mask=True)`` (a form that raised before this
    slice) and ``max_unpool2d`` round trip, as in the JAX package; the
    ``MaxUnPool2D`` layer and ``Fold`` too."""
    x = _data(1)["x"]
    outs = []
    for p, F in ((jp, JF), (tp, TF)):
        pooled, mask = F.max_pool2d(p.to_tensor(x), 2, 2, return_mask=True)
        outs.append(_np(F.max_unpool2d(pooled, mask, 2, 2,
                                       output_size=[4, 5])))
        outs.append(_np(p.nn.MaxUnPool2D(2, output_size=[4, 5])(pooled,
                                                                 mask)))
        cols = F.unfold(p.to_tensor(x), [2, 3])
        outs.append(_np(p.nn.Fold([4, 5], [2, 3])(cols)))
    for g, w in zip(outs[3:], outs[:3]):
        _close(g, w, "unpool")


@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular"])
def test_conv2d_padding_mode_pads_the_input(mode):
    """``Conv2D(padding_mode=...)`` (raised before this slice) pads with
    that mode and convolves unpadded: Paddle's meaning (the JAX package
    ignores the argument, ROADMAP queue C)."""
    tp.seed(0)
    conv = tp.nn.Conv2D(3, 4, 3, padding=1, padding_mode=mode)
    x = tp.to_tensor(_data(2)["x"])
    want = TF.conv2d(TF.pad(x, [1, 1, 1, 1], mode), conv.weight, conv.bias)
    _close(_np(conv(x)), _np(want), mode)
    zeros = tp.nn.Conv2D(3, 4, 3, padding=1)
    zeros.set_state_dict(conv.state_dict())
    assert not np.allclose(_np(zeros(x)), _np(conv(x)))


# ---------------------------------------------------------------- layers --

LAYERS = {
    "ReLU6": lambda n: n.ReLU6(), "GELU": lambda n: n.GELU(True),
    "LeakyReLU": lambda n: n.LeakyReLU(0.2), "ELU": lambda n: n.ELU(0.5),
    "CELU": lambda n: n.CELU(), "SELU": lambda n: n.SELU(),
    "Hardtanh": lambda n: n.Hardtanh(-0.5, 0.5),
    "Softplus": lambda n: n.Softplus(2.0), "PReLU": lambda n: n.PReLU(6),
    "Softmax": lambda n: n.Softmax(1), "LogSoftmax": lambda n: n.LogSoftmax(),
    "Maxout": lambda n: n.Maxout(3, 1), "GLU": lambda n: n.GLU(1),
    "Swish": lambda n: n.Swish(), "Mish": lambda n: n.Mish(),
    "Identity": lambda n: n.Identity(),
    "Upsample": lambda n: n.Upsample(scale_factor=2, mode="bilinear"),
    "UpsamplingNearest2D": lambda n: n.UpsamplingNearest2D([3, 7]),
    "Pad2D": lambda n: n.Pad2D([1, 0, 2, 1], mode="replicate"),
    "ZeroPad2D": lambda n: n.ZeroPad2D([1, 0, 2, 1]),
    "Conv1D": lambda n: n.Conv1D(6, 4, 3, padding=1),
    "Conv2D": lambda n: n.Conv2D(6, 4, 3, stride=2, padding="SAME"),
    "Conv3D": lambda n: n.Conv3D(6, 2, 2),
    "Conv2DTranspose": lambda n: n.Conv2DTranspose(6, 3, 3, stride=2,
                                                   padding=1),
    "Conv1DTranspose": lambda n: n.Conv1DTranspose(6, 3, 3, stride=2),
    "Conv3DTranspose": lambda n: n.Conv3DTranspose(6, 2, 2, stride=2),
    "BatchNorm1D": lambda n: n.BatchNorm1D(6),
    "BatchNorm2D": lambda n: n.BatchNorm2D(6),
    "BatchNorm3D": lambda n: n.BatchNorm3D(6),
    "SyncBatchNorm": lambda n: n.SyncBatchNorm(6),
    "BatchNorm": lambda n: n.BatchNorm(6, act="relu"),
    "GroupNorm": lambda n: n.GroupNorm(3, 6),
    "InstanceNorm2D": lambda n: n.InstanceNorm2D(6),
    "LocalResponseNorm": lambda n: n.LocalResponseNorm(3),
    "MaxPool1D": lambda n: n.MaxPool1D(2), "AvgPool1D": lambda n:
        n.AvgPool1D(2, 1, 1), "AvgPool2D": lambda n: n.AvgPool2D(2, 1),
    "MaxPool3D": lambda n: n.MaxPool3D(2), "AvgPool3D": lambda n:
        n.AvgPool3D(2, 1, 1),
    "AdaptiveAvgPool1D": lambda n: n.AdaptiveAvgPool1D(3),
    "AdaptiveMaxPool2D": lambda n: n.AdaptiveMaxPool2D(2),
    "AdaptiveAvgPool3D": lambda n: n.AdaptiveAvgPool3D(2),
    "AdaptiveMaxPool1D": lambda n: n.AdaptiveMaxPool1D(2),
    "AdaptiveMaxPool3D": lambda n: n.AdaptiveMaxPool3D(2),
    "PixelShuffle": lambda n: n.PixelShuffle(1),
    "PixelUnshuffle": lambda n: n.PixelUnshuffle(2),
    "ChannelShuffle": lambda n: n.ChannelShuffle(3),
    "Unfold": lambda n: n.Unfold(2),
    "LogSigmoid": lambda n: n.LogSigmoid(),
    "Softmax2D": lambda n: n.Softmax2D(),
    "Flatten": lambda n: n.Flatten(),
    "ReLU": lambda n: n.ReLU(), "Sigmoid": lambda n: n.Sigmoid(),
    "Tanh": lambda n: n.Tanh(), "Silu": lambda n: n.Silu(),
    "Hardswish": lambda n: n.Hardswish(),
    "Hardsigmoid": lambda n: n.Hardsigmoid(),
    "Tanhshrink": lambda n: n.Tanhshrink(),
    "Softsign": lambda n: n.Softsign(),
    "Hardshrink": lambda n: n.Hardshrink(0.3),
    "Softshrink": lambda n: n.Softshrink(0.2),
    "ThresholdedReLU": lambda n: n.ThresholdedReLU(0.1),
    "RReLU": lambda n: n.RReLU().eval(),
    "Pad1D": lambda n: n.Pad1D([1, 2], mode="reflect"),
    "Pad3D": lambda n: n.Pad3D([1, 0, 0, 1, 2, 0], mode="circular"),
    "UpsamplingBilinear2D": lambda n: n.UpsamplingBilinear2D([5, 3]),
    "InstanceNorm1D": lambda n: n.InstanceNorm1D(6),
    "InstanceNorm3D": lambda n: n.InstanceNorm3D(6),
}
# the input rank each layer takes (batch 2, 6 channels, spatial 4 each)
RANK = {"Pad1D": 3, "InstanceNorm1D": 3, "Pad3D": 5, "InstanceNorm3D": 5,
        "Conv1D": 3, "Conv1DTranspose": 3, "BatchNorm1D": 3,
        "MaxPool1D": 3, "AvgPool1D": 3, "AdaptiveAvgPool1D": 3,
        "AdaptiveMaxPool1D": 3, "Conv3D": 5, "Conv3DTranspose": 5,
        "BatchNorm3D": 5, "MaxPool3D": 5, "AvgPool3D": 5,
        "AdaptiveAvgPool3D": 5, "AdaptiveMaxPool3D": 5}


def _carried(make):
    """The JAX layer and the port's, the JAX weights carried over."""
    jl, tl = make(jp.nn), make(tp.nn)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    layer_state_from_jax(state, tl)
    return jl, tl


def _grads_jax(layer, x):
    xt = jp.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    jp.sum(out * out).backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()
             if p.grad is not None}
    return _np(out), grads, _np(xt.grad)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    x = np.random.RandomState(len(name)).randn(
        *([2, 6] + [4] * (RANK.get(name, 4) - 2))).astype("float32")
    jl, tl = _carried(LAYERS[name])
    want, wgrads, xgrad = _grads_jax(jl, x)
    xt = tp.to_tensor(x, stop_gradient=False)
    out = tl(xt)
    torch.sum(out * out).backward()
    _close(_np(out), want, name)
    np.testing.assert_allclose(_np(xt.grad), xgrad, rtol=GRAD_RTOL,
                               atol=1e-5, err_msg=f"{name} input")
    for n, p in tl.named_parameters():
        if n in wgrads:
            np.testing.assert_allclose(_np(p.grad), wgrads[n],
                                       rtol=GRAD_RTOL, atol=1e-5,
                                       err_msg=f"{name}.{n}")


def test_batch_norm_layers_update_statistics_like_jax():
    x = np.random.RandomState(5).randn(4, 6, 3).astype("float32")
    jl, tl = _carried(lambda n: n.BatchNorm1D(6, momentum=0.8))
    jl(jp.to_tensor(x))
    tl(tp.to_tensor(x))
    for k in ("_mean", "_variance"):
        _close(_np(getattr(tl, k)), _np(getattr(jl, k)), k)


@pytest.mark.parametrize("name", ["Bilinear", "CosineSimilarity",
                                  "PairwiseDistance"])
def test_two_input_layers_match_jax(name):
    make = {"Bilinear": lambda n: n.Bilinear(5, 4, 3),
            "CosineSimilarity": lambda n: n.CosineSimilarity(axis=1),
            "PairwiseDistance": lambda n: n.PairwiseDistance(1.0)}[name]
    r = np.random.RandomState(9)
    a, b = r.randn(3, 5).astype("float32"), r.randn(3, 4).astype("float32")
    if name != "Bilinear":
        b = r.randn(3, 5).astype("float32")
    jl, tl = _carried(make)
    _close(_np(tl(tp.to_tensor(a), tp.to_tensor(b))),
           _np(jl(jp.to_tensor(a), jp.to_tensor(b))), name)


LOSS_LAYERS = {
    "CosineEmbeddingLoss": (lambda n: n.CosineEmbeddingLoss(0.2),
                            ["h", "h2", "ypm"]),
    "HingeEmbeddingLoss": (lambda n: n.HingeEmbeddingLoss(),
                           ["h0", "ypm"]),
    "SoftMarginLoss": (lambda n: n.SoftMarginLoss("sum"), ["h0", "ypm"]),
    "MultiLabelSoftMarginLoss": (lambda n: n.MultiLabelSoftMarginLoss(),
                                 ["h", "y01"]),
    "MultiMarginLoss": (lambda n: n.MultiMarginLoss(margin=0.5),
                        ["h", "cls"]),
    "TripletMarginLoss": (lambda n: n.TripletMarginLoss(p=1.0),
                          ["h", "h2", "h3"]),
    "TripletMarginWithDistanceLoss": (
        lambda n: n.TripletMarginWithDistanceLoss(), ["h", "h2", "h3"]),
    "CTCLoss": (lambda n: n.CTCLoss(), ["ctc", "lab", "il", "ll"]),
    "HSigmoidLoss": (lambda n: n.HSigmoidLoss(6, 6), ["h", "cls"]),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layers_match_jax(name):
    make, keys = LOSS_LAYERS[name]
    d = _data(7)
    d.update(h0=d["h"][:, 0], h3=d["h"] * 0.3,
             ctc=d["x"].reshape(5, 2, 12),
             lab=np.array([[1, 2, 2], [3, 0, 0]], "int32"),
             il=np.array([5, 4], "int64"), ll=np.array([3, 1], "int64"))
    jl, tl = _carried(make)
    _close(_np(tl(*[tp.to_tensor(d[k]) for k in keys])),
           _np(jl(*[jp.to_tensor(d[k]) for k in keys])), name)


def test_containers():
    tl = tp.nn.LayerList([tp.nn.ReLU(), tp.nn.Tanh()])
    tl.append(tp.nn.Sigmoid())
    tl.insert(0, tp.nn.Identity())
    assert [type(m).__name__ for m in tl] == ["Identity", "ReLU", "Tanh",
                                              "Sigmoid"]
    assert type(tl[-1]).__name__ == "Sigmoid" and len(tl[1:]) == 3
    pl = tp.nn.ParameterList([tp.nn.Parameter(torch.ones(2))])
    pl.append(tp.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and len(list(pl)) == 2
    assert [n for n, _ in tp.nn.Sequential(
        ("a", tp.nn.Linear(2, 3)), ("b", tp.nn.ReLU())).named_parameters()
    ] == ["a.weight", "a.bias"]
    ld = tp.nn.LayerDict({"x": tp.nn.ReLU()})
    ld["y"] = tp.nn.Linear(2, 2)
    assert list(ld.keys()) == ["x", "y"] and "y" in ld
    assert len(ld.state_dict()) == 2
    ld.pop("y")
    assert len(ld) == 1


def test_spectral_norm_layer_matches_jax():
    w = np.random.RandomState(2).randn(4, 3, 2).astype("float32")
    jl, tl = _carried(lambda n: n.SpectralNorm([4, 3, 2], dim=1,
                                               power_iters=2))
    jw, tw = jp.to_tensor(w, stop_gradient=False), tp.to_tensor(
        w, stop_gradient=False)
    jo, to = jl(jw), tl(tw)
    _close(_np(to), _np(jo), "spectral")
    jp.sum(jo * jo).backward()
    torch.sum(to * to).backward()
    np.testing.assert_allclose(_np(tw.grad), _np(jw.grad), rtol=GRAD_RTOL,
                               atol=1e-5)
    _close(_np(tl.weight_u), _np(jl.weight_u), "u")


# ---------------------------------------------------------------- utils --


def test_weight_norm_matches_jax_and_removes():
    jl, tl = _carried(lambda n: n.Linear(4, 3))
    jp.nn.utils.weight_norm(jl, dim=1)
    tp.nn.utils.weight_norm(tl, dim=1)
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(
        n for n, _ in jl.named_parameters())
    x = np.random.RandomState(3).randn(2, 4).astype("float32")
    jo, to = jl(jp.to_tensor(x)), tl(tp.to_tensor(x))
    _close(_np(to), _np(jo), "weight_norm")
    jp.sum(jo * jo).backward()
    torch.sum(to * to).backward()
    jgrads = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jgrads[n].grad),
                                   rtol=GRAD_RTOL, atol=1e-6, err_msg=n)
    tp.nn.utils.remove_weight_norm(tl)
    jp.nn.utils.remove_weight_norm(jl)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]
    _close(_np(tl.weight), _np(jl.weight), "baked")


def test_spectral_norm_util_matches_jax():
    jl, tl = _carried(lambda n: n.Linear(5, 4))
    jp.nn.utils.spectral_norm(jl, n_power_iterations=2)
    tp.nn.utils.spectral_norm(tl, n_power_iterations=2)
    _close(_np(tl.weight_u), _np(jl.weight_u), "u0")
    x = np.random.RandomState(4).randn(3, 5).astype("float32")
    for _ in range(2):
        jo, to = jl(jp.to_tensor(x)), tl(tp.to_tensor(x))
        _close(_np(to), _np(jo), "spectral_norm")
    jp.sum(jo * jo).backward()
    torch.sum(to * to).backward()
    np.testing.assert_allclose(_np(tl.weight_orig.grad),
                               _np(jl.weight_orig.grad), rtol=GRAD_RTOL,
                               atol=1e-6)
    _close(_np(tl.weight_v), _np(jl.weight_v), "v")


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type):
    g = np.random.RandomState(6).randn(3, 4).astype("float32") * 3
    totals, grads = [], []
    for p in (jp, tp):
        w = p.to_tensor(g, stop_gradient=False)
        p.sum(w * w).backward()
        totals.append(_np(p.nn.utils.clip_grad_norm_([w], 1.5, norm_type)))
        p.nn.utils.clip_grad_value_([w], 0.5)
        grads.append(_np(w.grad))
    _close(totals[1], totals[0], "total")
    _close(grads[1], grads[0], "clipped")


def test_parameters_vector_round_trip_matches_jax():
    jl, tl = _carried(lambda n: n.Linear(3, 2))
    jv = _np(jp.nn.utils.parameters_to_vector(jl.parameters()))
    tv = tp.nn.utils.parameters_to_vector(tl.parameters())
    _close(_np(tv), jv, "vector")
    tp.nn.utils.vector_to_parameters(tv * 2, tl.parameters())
    _close(_np(tl.weight), 2 * _np(jl.weight), "weight")
    with pytest.raises(ValueError):
        tp.nn.utils.vector_to_parameters(tv[:3], tl.parameters())


def test_param_attr_sets_initializer_and_trainable():
    attr = tp.nn.ParamAttr(initializer=tp.nn.initializer.Constant(0.5),
                           trainable=False)
    lin = tp.nn.Linear(2, 3, weight_attr=attr)
    assert np.all(_np(lin.weight) == 0.5) and lin.weight.stop_gradient
    assert tp.ParamAttr is tp.nn.ParamAttr


@pytest.mark.parametrize("name", ["rrelu", "gumbel_softmax",
                                  "gumbel_softmax_hard"])
def test_threefry_draws_are_the_jax_bits(name):
    """``rrelu`` in training and ``gumbel_softmax`` draw threefry
    uniforms, as the JAX package's do: equal outputs from one seed."""
    import paddle_tpu.core.random as jrandom
    from paddle_tpu_torch.core import random as trandom

    x = np.random.RandomState(8).randn(4, 6).astype("float32")
    call = {"rrelu": lambda F, t: F.rrelu(t, 0.1, 0.4, training=True),
            "gumbel_softmax": lambda F, t: F.gumbel_softmax(t, 0.5),
            "gumbel_softmax_hard": lambda F, t: F.gumbel_softmax(
                t, 2.0, hard=True)}[name]
    jrandom.seed(21)
    trandom.default_generator.manual_seed(21)
    _close(_np(call(TF, tp.to_tensor(x))), _np(call(JF, jp.to_tensor(x))),
           name)


@pytest.mark.parametrize("name", ["relu_", "tanh_", "elu_", "selu_",
                                  "softmax_"])
def test_inplace_activations_match_jax(name):
    """The in-place forms against the JAX package's (its ``selu_`` is
    the registry's op object, not an in-place function: against
    ``selu``)."""
    x = np.random.RandomState(9).randn(3, 5).astype("float32")
    jt, tt = jp.to_tensor(x), tp.to_tensor(x)
    if name == "selu_":
        jt = JF.selu(jt)
    else:
        getattr(JF, name)(jt)
    out = getattr(TF, name)(tt)
    assert out is tt
    _close(_np(tt), _np(jt), name)


def test_class_center_sample_keeps_positives_and_remaps():
    """Every positive class is sampled, the rest drawn up to the count
    (torch generator: the numbers differ from JAX's), labels remapped
    into the sample."""
    tp.seed(4)
    label = tp.to_tensor(np.array([3, 7, 3, 9], "int64"))
    remap, sampled = TF.class_center_sample(label, 20, 6)
    s = _np(sampled).tolist()
    assert len(s) == 6 and s == sorted(s) and {3, 7, 9} <= set(s)
    np.testing.assert_array_equal(np.array(s)[_np(remap)], _np(label))
