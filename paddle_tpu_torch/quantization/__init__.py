"""``paddle.quantization``: QAT and PTQ with straight-through gradients.

Counterpart of ``paddle_tpu/quantization/__init__.py`` (reference:
``python/paddle/quantization/``). Fake quantization is
``x + (qdq(x) - x).detach()``: the straight-through estimator falls out
of autograd. Observers are layers whose running abs-max lives in
buffers, updated on the tensor's device with no read to the host (the
JAX package reads each abs-max to a Python float and does the moving
average in float64; here the same float64 arithmetic runs on the
device, so the scales are the same bits).

``PTQ.convert_int8`` bakes ``Linear`` and ``Conv2D`` layers to int8
with per-output-channel weight scales. A converted ``Linear`` quantizes
each input row (``kernels/int8.py`` ``quantize_rows``) and multiplies
through the int8 matmul kernel (``int8_matmul``, ``csrc/int8_matmul.cu``):
int32 sums, then ``acc * x_scale * w_scale`` in that order, as the JAX
``int8_linear_fn``. A converted ``Conv2D`` takes one per-tensor
activation scale, unfolds the input (im2col), quantizes the columns with
that scale (a padding zero quantizes to 0) and multiplies them through
the same kernel, every row scaled by the one activation scale: the JAX
``int8_conv2d_fn``'s exact int32 sums and epilogue. Both pad K with zero
codes to the kernel's multiple of 16.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.tensor import to_tensor
from ..kernels import int8 as _i8
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.conv import Conv2D
from ..nn.layer.layers import Layer

__all__ = [
    "QuantConfig", "QAT", "PTQ", "BaseQuanter",
    "FakeQuanterWithAbsMaxObserver", "AbsMaxObserver",
    "QuantedLinear", "QuantedConv2D", "quanter",
]


def _qdq(x, scale, bits: int):
    """Quantize-dequantize with a straight-through gradient:
    ``round(x / s).clip(-qmax, qmax) * s`` with ``s = scale / qmax``,
    both divisions by tensors (PyTorch divides a CUDA tensor by a Python
    number as a multiply by its reciprocal, an ulp from JAX's
    division)."""
    qmax = float(2 ** (bits - 1) - 1)
    s = scale / torch.full_like(scale, qmax)
    with torch.no_grad():
        q = torch.clamp(torch.round(x / s), -qmax, qmax) * s
        delta = q - x
    return x + delta


class BaseQuanter(Layer):
    bits = 8

    def scales(self):
        raise NotImplementedError


class AbsMaxObserver(BaseQuanter):
    """PTQ observer: the running ``max(|x|)`` over calibration batches;
    after ``PTQ.convert`` it fake-quantizes with that scale."""

    def __init__(self, quant_bits=8):
        super().__init__()
        self.bits = quant_bits
        self.register_buffer("_absmax", to_tensor(np.zeros((), "float32")))
        self._observing = True

    def forward(self, x):
        if self._observing:
            with torch.no_grad():
                cur = x.detach().abs().amax().to(torch.float32)
                self._absmax.copy_(torch.maximum(self._absmax, cur))
            return x
        return _qdq(x, self.scales(), self.bits)

    def scales(self):
        # the floor guards an uncalibrated or all-zero calibration
        return torch.clamp(self._absmax, min=1e-9)


class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    """QAT fake-quanter: a moving-average abs-max scale and the
    straight-through quantization."""

    def __init__(self, moving_rate=0.9, quant_bits=8, dtype="float32"):
        super().__init__()
        self._rate = moving_rate
        self.bits = quant_bits
        self.register_buffer("_scale", to_tensor(np.zeros((), "float32")))
        self.register_buffer("_state", to_tensor(np.zeros((), "float32")))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x.detach().abs().amax().to(torch.float64)
                state = self._state.double()
                st = state * self._rate + 1.0
                sc = (self._scale.double() * self._rate * state + cur) / st
                sc = torch.where(st > 0, sc, cur)
                self._state.copy_(st.float())
                self._scale.copy_(sc.float())
        return _qdq(x, torch.clamp(self._scale, min=1e-9), self.bits)

    def scales(self):
        return self._scale


def quanter(name):
    """The reference's ``@quanter`` registration decorator (a no-op)."""

    def deco(cls):
        return cls

    return deco


class _QuanterFactory:
    def __init__(self, cls, **kwargs):
        self._cls = cls
        self._kwargs = kwargs

    def _instance(self):
        return self._cls(**self._kwargs)


class QuantConfig:
    """Which layers get which activation and weight quanters."""

    def __init__(self, activation=None, weight=None):
        self._global_act = activation
        self._global_w = weight
        self._layer_cfg = {}  # id(layer) -> (act, w)
        self._type_cfg = {}  # layer class -> (act, w)

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._layer_cfg[id(l)] = (activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = (layer_type if isinstance(layer_type, (list, tuple))
                 else [layer_type])
        for t in types:
            self._type_cfg[t] = (activation, weight)

    def _config_for(self, layer):
        if id(layer) in self._layer_cfg:
            return self._layer_cfg[id(layer)]
        for t, cfg in self._type_cfg.items():
            if isinstance(layer, t):
                return cfg
        return (self._global_act, self._global_w)

    @staticmethod
    def _make(q):
        if q is None:
            return None
        if isinstance(q, _QuanterFactory):
            return q._instance()
        if isinstance(q, type):
            return q()
        return copy.deepcopy(q)


class QuantedLinear(Layer):
    """``Linear`` with fake-quantized weights and activations."""

    def __init__(self, src: Linear, act_q, w_q):
        super().__init__()
        self.weight = src.weight
        self.bias = src.bias
        self.activation_quanter = act_q
        self.weight_quanter = w_q

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.linear(x, w, self.bias)


class QuantedConv2D(Layer):
    """``Conv2D`` with fake-quantized weights and activations (it keeps
    the source's configuration, not the source layer, so a second
    ``quantize`` does not wrap it twice)."""

    def __init__(self, src: Conv2D, act_q, w_q):
        super().__init__()
        self.weight = src.weight
        self.bias = src.bias
        self._stride = src._stride
        self._padding = src._padding
        self._dilation = src._dilation
        self._groups = src._groups
        self._data_format = src._data_format
        self.activation_quanter = act_q
        self.weight_quanter = w_q

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.conv2d(x, w, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


_QUANTED = {Linear: QuantedLinear, Conv2D: QuantedConv2D}


def _swap_layers(model: Layer, config: QuantConfig, observer_only=False):
    for name, sub in list(model._modules.items()):
        cls = type(sub)
        if isinstance(sub, (QuantedLinear, QuantedConv2D)):
            continue  # already quantized: never wrap twice
        if cls in _QUANTED:
            act, w = config._config_for(sub)
            if act is None and w is None:
                continue
            # a quanter's state lives where the layer it wraps does
            act_q, w_q = (None if q is None else
                          QuantConfig._make(q).to(sub.weight.device)
                          for q in (act, w))
            if observer_only:
                for q in (act_q, w_q):
                    if q is not None and hasattr(q, "_observing"):
                        q._observing = True
            model._modules[name] = _QUANTED[cls](sub, act_q, w_q)
        elif sub is not None:
            _swap_layers(sub, config, observer_only)
    return model


class QAT:
    """Quantization-aware training: ``quantize`` swaps every configured
    ``Linear`` and ``Conv2D`` for its fake-quantized form."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model: Layer, inplace=False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        return _swap_layers(model, self._config)

    def convert(self, model: Layer, inplace=False) -> Layer:
        """Freeze the scales: the quanters go to eval mode."""
        if not inplace:
            model = copy.deepcopy(model)
        model.eval()
        return model


class PTQ:
    """Post-training quantization: ``quantize`` inserts observers, the
    caller runs calibration batches, ``convert`` freezes the scales,
    ``convert_int8`` bakes ``Linear`` / ``Conv2D`` to int8."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model: Layer, inplace=False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        return _swap_layers(model, self._config, observer_only=True)

    def convert(self, model: Layer, inplace=False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        for sub in model.sublayers(include_self=True):
            if isinstance(sub, AbsMaxObserver):
                sub._observing = False
        model.eval()
        return model

    def convert_int8(self, model: Layer, weight_only=False,
                     inplace=False) -> Layer:
        """Every ``Linear`` to :class:`_Int8LinearLayer`, and (unless
        ``weight_only``) every plain NCHW ``Conv2D`` with zero padding to
        :class:`_Int8Conv2DLayer`; a subclass that overrides ``forward``
        keeps its own."""
        if not inplace:
            model = copy.deepcopy(model)
        for layer in model.sublayers(include_self=True):
            for name, sub in list(layer._modules.items()):
                if isinstance(sub, Linear):
                    layer._modules[name] = _Int8LinearLayer(
                        sub.weight, sub.bias, weight_only)
                elif (isinstance(sub, Conv2D)
                        and type(sub).forward is Conv2D.forward
                        and sub._data_format == "NCHW"
                        and sub._padding_mode == "zeros"
                        and not weight_only):
                    layer._modules[name] = _Int8Conv2DLayer(sub)
        model.eval()
        return model


_K_MULTIPLE = 16        # the int8 matmul kernel's K step
_ROWS_PER_LAUNCH = 1 << 21


def _pad_k(codes):
    """``[R, K]`` int8 codes padded with zero columns to a multiple of
    16 (zero codes add nothing to the int32 sums)."""
    pad = -codes.shape[1] % _K_MULTIPLE
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    return codes.contiguous()


def _int8_rows(xq, xs, wqt, ws):
    """``int8_matmul`` over row blocks (the kernel's grid holds at most
    65,535 blocks of 64 rows)."""
    if xq.shape[0] <= _ROWS_PER_LAUNCH:
        return _i8.int8_matmul(xq, xs, wqt, ws)
    return torch.cat([
        _i8.int8_matmul(xq[r:r + _ROWS_PER_LAUNCH],
                        xs[r:r + _ROWS_PER_LAUNCH], wqt, ws)
        for r in range(0, xq.shape[0], _ROWS_PER_LAUNCH)])


class _Int8LinearLayer(Layer):
    """A converted ``Linear``: int8 weight codes ``w_q [K, N]`` and
    per-column scales ``w_scale [1, N]`` as buffers (the JAX names), the
    codes also kept transposed and K-padded for the kernel. With
    ``weight_only`` the activations stay float and the weight is
    dequantized into a plain product (the JAX
    ``weight_only_int8_linear``)."""

    def __init__(self, weight, bias=None, weight_only=False):
        super().__init__()
        w_q, w_scale = _i8.quantize_absmax(weight.detach(), axis=0)
        self._weight_only = weight_only
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self._has_bias = bias is not None
        if self._has_bias:
            self.register_buffer("bias", bias.detach().clone())
        self.register_buffer("_w_qt", _pad_k(w_q.t()), persistable=False)

    @torch.no_grad()
    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self._weight_only:
            w = self.w_q.to(x.dtype) * self.w_scale.to(x.dtype)
            out = x2 @ w
        else:
            xq, xs = _i8.quantize_rows(x2.to(torch.float32).contiguous())
            out = _int8_rows(_pad_k(xq), xs, self._w_qt,
                             self.w_scale.reshape(-1)).to(x.dtype)
        if self._has_bias:
            out = out + self.bias.to(out.dtype)
        return out.reshape(*shape[:-1], self.w_q.shape[1])


class _Int8Conv2DLayer(Layer):
    """A converted NCHW ``Conv2D``: per-output-channel int8 weight codes
    and scales as buffers (``w_q``, ``w_scale``, ``bias``, the JAX
    names), one dynamic per-tensor activation scale, im2col into the
    int8 matmul kernel."""

    def __init__(self, src):
        super().__init__()
        w_q, w_scale = _i8.quantize_absmax(src.weight.detach(),
                                           axis=(1, 2, 3))
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale.reshape(-1))
        self._has_bias = src.bias is not None
        if self._has_bias:
            self.register_buffer("bias", src.bias.detach().clone())
        self._kernel = tuple(w_q.shape[2:])
        self._stride = F._ntuple(src._stride, 2)
        self._dilation = F._ntuple(src._dilation, 2)
        self._padding = src._padding
        self._groups = src._groups
        og = w_q.shape[0] // self._groups
        self.register_buffer("_w_qt", torch.stack([
            _pad_k(w_q[g * og:(g + 1) * og].reshape(og, -1))
            for g in range(self._groups)]), persistable=False)

    @torch.no_grad()
    def forward(self, x):
        n, c, h, w = x.shape
        xf = x.to(torch.float32)
        amax = xf.abs().amax()
        scale = torch.clamp(amax / torch.full_like(amax, _i8.INT8_QMAX),
                            min=_i8.SCALE_EPS)
        pads = F._pads(self._padding, (h, w), self._kernel, self._stride,
                       self._dilation)
        (top, bottom), (left, right) = pads
        xp = torch.nn.functional.pad(xf, (left, right, top, bottom))
        cols = torch.nn.functional.unfold(xp, self._kernel,
                                          dilation=self._dilation,
                                          stride=self._stride)
        ho = (h + top + bottom - self._dilation[0] * (self._kernel[0] - 1)
              - 1) // self._stride[0] + 1
        wo = (w + left + right - self._dilation[1] * (self._kernel[1] - 1)
              - 1) // self._stride[1] + 1
        m = n * ho * wo
        codes = torch.clamp(torch.round(cols.transpose(1, 2) / scale),
                            -_i8.INT8_QMAX, _i8.INT8_QMAX).to(torch.int8)
        codes = codes.reshape(m, -1)
        del cols
        xs = scale.reshape(1).expand(m).contiguous()
        o = self.w_q.shape[0]
        og, kg = o // self._groups, codes.shape[1] // self._groups
        outs = [_int8_rows(_pad_k(codes[:, g * kg:(g + 1) * kg]), xs,
                           self._w_qt[g],
                           self.w_scale[g * og:(g + 1) * og].contiguous())
                for g in range(self._groups)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        out = out.reshape(n, ho * wo, o).transpose(1, 2).reshape(
            n, o, ho, wo).to(x.dtype)
        if self._has_bias:
            out = out + self.bias.to(out.dtype)[None, :, None, None]
        return out
