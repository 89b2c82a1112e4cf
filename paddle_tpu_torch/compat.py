"""Paddle's top-level compatibility names (counterpart of
``paddle_tpu/compat.py``): places, the CUDA generators' state, print
options, ``DataParallel``, ``LazyGuard``, dtype queries and the legacy
``batch`` reader helper.

``CUDAPlace(i)`` and ``TPUPlace(i)`` both name the card ``cuda:i``.
``get_cuda_rng_state`` / ``set_cuda_rng_state`` read and write the
state of the torch generator of each card, the one ``paddle.seed``
seeds and the initializers draw from. ``DataParallel`` in one process
is the layer it wraps (the multi-process path is ``distributed``'s).
"""
from __future__ import annotations

import torch

from .core import dtypes as _dt
from .core import random as _rng
from .core.device import CPUPlace, Place, TPUPlace, is_compiled_with_tpu
from .core.tensor import to_tensor_arg
from .nn.layer.layers import Layer, create_parameter
from .nn.utils import ParamAttr

__all__ = ["Place", "CPUPlace", "TPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "NPUPlace", "is_compiled_with_tpu", "DataParallel", "LazyGuard",
           "batch", "check_shape", "disable_signal_handler", "dtype",
           "get_cuda_rng_state", "set_cuda_rng_state", "iinfo",
           "is_complex", "is_floating_point", "is_integer",
           "set_printoptions", "create_parameter", "ParamAttr"]


class CUDAPlace(Place):
    """The card ``cuda:device_id``."""

    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class CUDAPinnedPlace(Place):
    def __init__(self):
        super().__init__("cuda_pinned", 0)


class NPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("npu", device_id)


class DataParallel(Layer):
    """Wraps a layer for data-parallel training. In one process it is
    the wrapped layer: ``forward``, ``state_dict`` and
    ``set_state_dict`` pass through under the layer's own names, and
    ``scale_loss`` returns the loss."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    load_dict = set_state_dict


class LazyGuard:
    """Paddle's lazy parameter scope: parameters are made at once, as
    in the JAX package."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """The legacy reader helper: ``reader``'s samples in lists of
    ``batch_size`` (the last one shorter unless ``drop_last``)."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def check_shape(shape):
    for s in list(shape):
        if s is not None and int(s) < -1:
            raise ValueError(f"invalid dim {s} in shape {shape}")


def disable_signal_handler():
    pass  # the port installs no signal handlers


dtype = _dt.convert_dtype


def is_complex(x) -> bool:
    return to_tensor_arg(x).is_complex()


def is_floating_point(x) -> bool:
    return to_tensor_arg(x).is_floating_point()


def is_integer(x) -> bool:
    """True for the integer dtypes and ``bool``, as the JAX package's."""
    t = to_tensor_arg(x)
    return not (t.is_floating_point() or t.is_complex())


def iinfo(dtype):
    """``torch.iinfo`` of a Paddle or torch integer dtype (``min``,
    ``max``, ``bits``, as numpy's)."""
    return torch.iinfo(_dt.convert_dtype(dtype))


def get_cuda_rng_state():
    """The state of each card's torch generator (an empty list without
    a card)."""
    return [_rng.get_rng_state(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    for i, state in enumerate(state_list):
        _rng.set_rng_state(state, f"cuda:{i}")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """torch's print options, which the port's tensors print with."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)
