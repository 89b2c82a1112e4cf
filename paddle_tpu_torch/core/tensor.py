"""Paddle's eager ``Tensor`` as a ``torch.Tensor`` subclass.

Counterpart of ``paddle_tpu/core/tensor.py``. The JAX package wraps an
immutable array and records its own tape; here the value *is* a torch
tensor and autograd is torch's, so the class only adds Paddle's surface:

- ``stop_gradient``, the inverse of ``requires_grad`` (True by default,
  as in Paddle): setting it to False on a leaf turns its gradient on;
- ``numpy()`` from any device (bfloat16 comes back as float32: numpy
  has no bfloat16), ``astype`` with Paddle's dtype names, ``place``,
  ``clear_grad``.

Every torch function or method given a ``Tensor`` returns ``Tensor``
(``__torch_function__``), so results, and gradients read through
``.grad``, keep the surface. That hook runs in Python on every op (a
few microseconds of host time); the GPU's time per op is unchanged.
Names that torch already defines keep torch's meaning: ``shape`` is a
``torch.Size``, ``size()`` a method, ``transpose(d0, d1)`` swaps two
axes (the top-level functions in ``ops`` take Paddle's arguments).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes as _dt
from .device import to_torch_device

__all__ = ["Tensor", "to_tensor", "to_tensor_arg", "as_tensor", "from_numpy"]


def _wrap(out):
    if isinstance(out, torch.Tensor) and not isinstance(out, Tensor):
        return out.as_subclass(Tensor)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


class Tensor(torch.Tensor):
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        return _wrap(out)

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not value)

    @property
    def place(self) -> torch.device:
        return self.device

    def numpy(self) -> np.ndarray:
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.cpu())

    def astype(self, dtype) -> "Tensor":
        return self.to(_dt.convert_dtype(dtype))

    def clear_grad(self) -> None:
        self.grad = None


def as_tensor(t: torch.Tensor, stop_gradient: bool = True) -> Tensor:
    """``t`` (a torch tensor that tracks no gradient) as a leaf ``Tensor``
    sharing its storage."""
    out = t.as_subclass(Tensor)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A torch copy of a numpy array, numpy's ``bfloat16`` extension
    type (what the JAX package's bfloat16 arrays become) included."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: a new leaf ``Tensor`` holding a copy of
    ``data`` (a tensor, array, list or scalar) on ``place`` (default:
    the current device). Python floats become the default dtype."""
    dtype = _dt.convert_dtype(dtype)
    dev = to_torch_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=dtype, copy=True)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            dtype = _dt.get_default_dtype()
        t = from_numpy(arr).to(device=dev, dtype=dtype)
    return as_tensor(t.as_subclass(torch.Tensor), stop_gradient)


def to_tensor_arg(x):
    """An op's positional argument as a tensor: tensors pass through,
    arrays, lists and numpy scalars are copied to the current device.
    Python numbers stay numbers (torch broadcasts them)."""
    if isinstance(x, torch.Tensor) or isinstance(x, (bool, int, float)):
        return x
    return to_tensor(x)
