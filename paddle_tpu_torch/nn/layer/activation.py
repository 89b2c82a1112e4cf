"""Activation layers (counterpart of
``paddle_tpu/nn/layer/activation.py``): each wraps its functional,
keeping its arguments (in order or by keyword)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer, functional_layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Mish", "Hardswish",
           "Tanhshrink", "Softsign", "GELU", "LeakyReLU", "ELU", "CELU",
           "SELU", "Hardtanh", "Hardsigmoid", "Hardshrink", "Softshrink",
           "Softplus", "ThresholdedReLU", "PReLU", "Softmax", "LogSoftmax",
           "Maxout", "GLU", "Swish"]


ReLU = functional_layer("ReLU", F.relu)
ReLU6 = functional_layer("ReLU6", F.relu6)
Sigmoid = functional_layer("Sigmoid", F.sigmoid)
Tanh = functional_layer("Tanh", F.tanh)
Silu = functional_layer("Silu", F.silu)
Swish = functional_layer("Swish", F.silu)
Mish = functional_layer("Mish", F.mish)
Hardswish = functional_layer("Hardswish", F.hardswish)
Hardsigmoid = functional_layer("Hardsigmoid", F.hardsigmoid)
Tanhshrink = functional_layer("Tanhshrink", F.tanhshrink)
Softsign = functional_layer("Softsign", F.softsign)
GELU = functional_layer("GELU", F.gelu, approximate=False)
LeakyReLU = functional_layer("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = functional_layer("ELU", F.elu, alpha=1.0)
CELU = functional_layer("CELU", F.celu, alpha=1.0)
SELU = functional_layer("SELU", F.selu, scale=1.0507009873554805,
                        alpha=1.6732632423543772)
Hardtanh = functional_layer("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = functional_layer("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = functional_layer("Softshrink", F.softshrink, threshold=0.5)
Softplus = functional_layer("Softplus", F.softplus, beta=1.0,
                            threshold=20.0)
ThresholdedReLU = functional_layer("ThresholdedReLU", F.thresholded_relu,
                                   threshold=1.0)
Softmax = functional_layer("Softmax", F.softmax, axis=-1)
LogSoftmax = functional_layer("LogSoftmax", F.log_softmax, axis=-1)
Maxout = functional_layer("Maxout", F.maxout, groups=1, axis=1)
GLU = functional_layer("GLU", F.glu, axis=-1)


class PReLU(Layer):
    """A learnt slope, one per channel or one in all (``init``)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
