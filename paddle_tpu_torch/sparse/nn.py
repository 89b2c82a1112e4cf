"""``paddle.sparse.nn``: layers over sparse tensors.

Counterpart of ``paddle_tpu/sparse/nn.py``. Activations and BatchNorm
run on the values (``nnz x channels``, a dense tensor). The 3-D
convolutions keep the JAX package's design: densify, run a dense
convolution (cuDNN's ``conv3d`` on the card) and gather the output at
the active sites. The output pattern of a submanifold conv is the
input's; that of a plain conv is the kernel's footprint over the input
*coordinates* (an indicator of the active sites convolved with ones), so
a site whose features are all zero stays active. ``MaxPool3D`` takes the
max over the active sites of each window (inactive sites are -inf) and
its pattern from the coordinates as well.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import to_numpy
from ..nn.layer.layers import Layer
from . import SparseCooTensor, leaky_relu, relu, relu6, softmax

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "Softmax", "BatchNorm",
           "SyncBatchNorm", "Conv3D", "SubmConv3D", "MaxPool3D"]


class ReLU(Layer):
    def forward(self, x):
        return relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return leaky_relu(x, self._slope)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return softmax(x, self._axis)


class BatchNorm(Layer):
    """Per-channel batch norm over the values (``nnz`` samples)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 use_global_stats=None, name=None):
        super().__init__()
        from ..nn.layer.norm import BatchNorm1D

        self._bn = BatchNorm1D(num_features, momentum=momentum,
                               epsilon=epsilon)

    def forward(self, x: SparseCooTensor):
        out = SparseCooTensor(x.indices(), self._bn(x.values()), x.shape,
                              x._coalesced)
        out._host = x._host
        return out


SyncBatchNorm = BatchNorm  # one card: the batch statistics are local


def _tuple3(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


def _indicator(x: SparseCooTensor) -> torch.Tensor:
    """``[N, 1, D, H, W]`` float32: 1 at the active sites."""
    shape = x.shape[:-1]
    ind = torch.zeros(shape, dtype=torch.float32, device=x.values().device)
    idx = x.indices()
    ind[tuple(idx[i] for i in range(idx.shape[0]))] = 1.0
    return ind[:, None]


def _active(foot: torch.Tensor):
    """The sites of ``foot [N, 1, D, H, W]`` above 0, row-major (numpy's
    order), on the device and on the host."""
    idx = torch.nonzero(foot[:, 0] > 0).t().contiguous()
    return idx, to_numpy(idx).astype(np.int64)


class _ConvBase(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, subm=False,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NDHWC"):
        super().__init__()
        if data_format != "NDHWC":
            raise ValueError("sparse conv expects NDHWC")
        if groups != 1:
            raise NotImplementedError("grouped sparse conv")
        self._in = in_channels
        self._out = out_channels
        self._k = _tuple3(kernel_size)
        self._stride = _tuple3(stride)
        self._pad = _tuple3(padding)
        self._dil = _tuple3(dilation)
        self._subm = subm
        # kernel layout [kd, kh, kw, in, out], the reference's
        self.weight = self.create_parameter(
            [*self._k, in_channels, out_channels], attr=weight_attr)
        self.bias = (self.create_parameter([out_channels], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def _conv(self, x, w):
        """NDHWC ``x`` conv DHWIO ``w`` -> NDHWC."""
        out = torch.nn.functional.conv3d(
            x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
            stride=self._stride, padding=self._pad, dilation=self._dil)
        return out.permute(0, 2, 3, 4, 1)

    def forward(self, x: SparseCooTensor):
        if not isinstance(x, SparseCooTensor):
            raise TypeError("sparse conv expects SparseCooTensor")
        out = self._conv(x.to_dense(), self.weight)
        if self._subm:
            idx, host = x.indices(), x._idx()
        else:
            ones = torch.ones((1, 1) + self._k, dtype=torch.float32,
                              device=out.device)
            foot = torch.nn.functional.conv3d(
                _indicator(x), ones, stride=self._stride, padding=self._pad,
                dilation=self._dil)
            idx, host = _active(foot)
        vals = out[tuple(idx[i] for i in range(idx.shape[0]))]
        if self.bias is not None:
            vals = vals + self.bias
        res = SparseCooTensor(idx, vals, list(out.shape[:-1]) + [self._out],
                              True)
        res._host = host
        return res


class Conv3D(_ConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, subm=False,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format)


class SubmConv3D(_ConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 key=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, subm=True,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC", name=None):
        super().__init__()
        self._k = _tuple3(kernel_size)
        self._stride = _tuple3(stride if stride is not None else kernel_size)
        self._pad = _tuple3(padding)

    def forward(self, x: SparseCooTensor):
        dense = x.to_dense()
        ind = _indicator(x)
        # inactive sites are -inf, so implicit zeros never win the max
        masked = torch.where(ind[:, 0, ..., None] > 0, dense,
                             torch.full_like(dense, float("-inf")))
        out = torch.nn.functional.max_pool3d(
            masked.permute(0, 4, 1, 2, 3), self._k, self._stride,
            self._pad).permute(0, 2, 3, 4, 1)
        foot = torch.nn.functional.max_pool3d(ind, self._k, self._stride,
                                              self._pad)
        idx, host = _active(foot)
        vals = out[tuple(idx[i] for i in range(idx.shape[0]))]
        res = SparseCooTensor(idx, vals, list(out.shape), True)
        res._host = host
        return res
