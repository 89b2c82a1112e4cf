"""PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference. The port has the Paddle-API core
(``import paddle_tpu_torch as paddle``: ``to_tensor``, the creation,
random, math, logic, reduction, search, shape, indexing and
linear-algebra ops with ``paddle.linalg``, ``Tensor`` with ``stop_gradient`` /
``backward()`` / ``.grad`` over torch's autograd, ``seed``,
``set_device``, ``nn.Layer`` with Paddle's layer families (the
Transformer, the recurrent layers, convolutions, norms, pools, losses)
and ``nn.functional``, ``optimizer``, ``amp``, ``jit.TrainStep``, ``autograd.PyLayer``,
``utils.custom_op`` / ``cuda_op``, ``utils.cpp_extension`` and kernel
plugins), compiles and exports programs (``jit.to_static`` as CUDA
graphs, ``jit.save`` / ``load`` through ``torch.export``, the
``static`` program recorder and its ``Executor``, ``static.sequence_*``
and the static tail), trains through the high-level API (``io.DataLoader``
with its worker ring, ``vision.datasets`` / ``transforms``, the loss
layers, ``metric``, ``Model(...).fit`` / ``evaluate`` / ``predict`` with
``callbacks``, ``summary``, ``flops``, ``save`` / ``load``), has BERT
(``text.bert``), the text datasets, ``incubate`` (the fused layers,
``LookAhead`` / ``ModelAverage``, ASP, functional autodiff, auto
checkpoints, shared-memory tensor passing), ``geometric`` and
``regularizer``, Paddle's initializers, ``device`` (streams, events,
the allocator's counters), the places and the rest of ``compat``,
``fft`` / ``signal`` / ``audio``, ``hub``, ``reader``, ``strings`` and
``sysconfig``, ``sparse`` (COO / CSR tensors, their ops and layers),
``distribution``, ``quantization`` (QAT, PTQ, int8 conversion on the
int8 kernels), ``profiler`` over ``torch.profiler``, ``cost_model`` and
``onnx`` export, serves the decoder-only LM
through the JAX engine's entry points (``inference.llm``) and trains the
GPT family (``text.gpt``) on an NVIDIA GPU, with the TPU's Pallas
kernels rewritten by hand for Hopper (``kernels/csrc``). It imports
``torch`` and never ``jax`` or anything of ``paddle_tpu``. Tensors go
to the card unless ``set_device("cpu")`` (or a ``place``) asks for the
host.
"""
from . import (amp, audio, autograd, callbacks, cost_model, device,
               distribution, fft, framework, geometric, hapi, hub, incubate,
               inference, io, jit, linalg, metric, nn, observability, onnx,
               optimizer, profiler, quantization, reader, regularizer,
               signal, sparse, static, strings, sysconfig, text, utils,
               vision)
from .compat import (CPUPlace, CUDAPinnedPlace, CUDAPlace, DataParallel,
                     LazyGuard, NPUPlace, Place, TPUPlace, batch,
                     check_shape, create_parameter, disable_signal_handler,
                     dtype, get_cuda_rng_state, iinfo, is_compiled_with_tpu,
                     is_complex, is_floating_point, is_integer,
                     set_cuda_rng_state, set_printoptions)
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.device import device_count, get_device, set_device
from .core.dtypes import (bfloat16, bool_, complex64, complex128, float16,
                          float32, float64, get_default_dtype, int8, int16,
                          int32, int64, set_default_dtype, uint8)
from .core.random import get_rng_state, seed, set_rng_state
from .core.tensor import Tensor
from .device import resolve_device
from .framework import get_flags, load, save, set_flags
from .hapi import Model, flops, summary
from .nn import ParamAttr, Parameter
from .nn.functional import log_softmax, softmax
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops
from .sparse import sparse_coo_tensor, sparse_csr_tensor
from .static import (disable_static, enable_static, in_dynamic_mode,
                     in_static_mode)

bool = bool_  # noqa: A001 - Paddle's dtype name
__version__ = "0.1.0"

__all__ = ["resolve_device", "Tensor", "Parameter", "ParamAttr", "bool",
           "linalg", "log_softmax", "softmax", "set_device",
           "get_device", "device_count", "seed", "get_rng_state",
           "set_rng_state", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "grad", "get_default_dtype",
           "set_default_dtype", "bool_", "uint8", "int8", "int16", "int32",
           "int64", "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128", "amp", "autograd", "jit", "nn", "optimizer",
           "static", "utils", "vision", "enable_static", "disable_static",
           "callbacks", "framework", "hapi", "io", "metric", "Model",
           "summary", "flops", "save", "load", "get_flags", "set_flags",
           "in_dynamic_mode", "in_static_mode", "geometric", "incubate",
           "regularizer", "text", "audio", "device", "fft", "hub",
           "inference", "observability", "reader", "signal", "strings",
           "sysconfig", "CPUPlace", "CUDAPinnedPlace", "CUDAPlace",
           "DataParallel", "LazyGuard", "NPUPlace", "Place", "TPUPlace",
           "batch", "check_shape", "create_parameter",
           "disable_signal_handler", "dtype", "get_cuda_rng_state", "iinfo",
           "is_compiled_with_tpu", "is_complex", "is_floating_point",
           "is_integer", "set_cuda_rng_state", "set_printoptions",
           "cost_model", "distribution", "onnx", "profiler", "quantization",
           "sparse", "sparse_coo_tensor", "sparse_csr_tensor", *_ops]
