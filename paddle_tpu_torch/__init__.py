"""PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference. The port has the Paddle-API core
(``import paddle_tpu_torch as paddle``: ``to_tensor``, the creation,
math, reduction and shape ops, ``Tensor`` with ``stop_gradient`` /
``backward()`` / ``.grad`` over torch's autograd, ``seed``,
``set_device``, ``nn.Layer`` and the layers of the GPT and ResNet
families, ``optimizer``, ``amp``, ``jit.TrainStep``, ``autograd.PyLayer``
and ``utils.custom_op`` / ``cuda_op``), serves the decoder-only LM
through the JAX engine's entry points (``inference.llm``) and trains the
GPT family (``text.gpt``) on an NVIDIA GPU, with the TPU's Pallas
kernels rewritten by hand for Hopper (``kernels/csrc``). It imports
``torch`` and never ``jax`` or anything of ``paddle_tpu``. Tensors go
to the card unless ``set_device("cpu")`` (or a ``place``) asks for the
host.
"""
from . import amp, autograd, jit, nn, optimizer, utils, vision
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.device import device_count, get_device, set_device
from .core.dtypes import (bfloat16, bool_, complex64, complex128, float16,
                          float32, float64, get_default_dtype, int8, int16,
                          int32, int64, set_default_dtype, uint8)
from .core.random import get_rng_state, seed, set_rng_state
from .core.tensor import Tensor
from .device import resolve_device
from .nn import Parameter
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops

__all__ = ["resolve_device", "Tensor", "Parameter", "set_device",
           "get_device", "device_count", "seed", "get_rng_state",
           "set_rng_state", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "grad", "get_default_dtype",
           "set_default_dtype", "bool_", "uint8", "int8", "int16", "int32",
           "int64", "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "amp", "autograd", "jit", "nn", "optimizer",
           "utils", "vision", *_ops]
