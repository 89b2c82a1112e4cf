"""Paddle's eager ``Tensor`` as a ``torch.Tensor`` subclass.

Counterpart of ``paddle_tpu/core/tensor.py``. The JAX package wraps an
immutable array and records its own tape; here the value *is* a torch
tensor and autograd is torch's, so the class only adds Paddle's surface:

- ``stop_gradient``, the inverse of ``requires_grad`` (True by default,
  as in Paddle): setting it to False on a leaf turns its gradient on;
- ``numpy()`` from any device (bfloat16 comes back as float32: numpy
  has no bfloat16), ``astype`` with Paddle's dtype names, ``place``,
  ``clear_grad``;
- Paddle's own methods that torch does not define (``cast``,
  ``scale``, ``reshape_``, ``set_value``, ``clear_gradient``,
  ``gather_nd``, ``concat``, ``add_n``, ...: ``PADDLE_METHODS``), each
  the port's top-level function of that name with the tensor first, as
  the JAX package's ``ops._patch_tensor`` installs them; ``tpu()``
  moves the tensor to the card, the port's accelerator.

Every torch function or method given a ``Tensor`` returns ``Tensor``
(``__torch_function__``), so results, and gradients read through
``.grad``, keep the surface. That hook runs in Python on every op (a
few microseconds of host time); the GPU's time per op is unchanged.
Names that torch already defines keep torch's meaning: ``shape`` is a
``torch.Size``, ``size()`` a method, ``transpose(d0, d1)`` swaps two
axes (the top-level functions in ``ops`` take Paddle's arguments).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import dtypes as _dt
from .device import to_torch_device

__all__ = ["Tensor", "to_tensor", "to_tensor_arg", "as_tensor", "from_numpy",
           "to_numpy", "PADDLE_METHODS",
           "CHECK_NAN_INF", "check_finite"]

# ``FLAGS_check_nan_inf`` (``framework/flags.py`` sets it): every torch
# function or method given a ``Tensor``, and every registered op, checks
# its floating outputs
CHECK_NAN_INF = [False]


def check_finite(name: str, out) -> None:
    """Raise ``FloatingPointError`` when a floating tensor in ``out`` holds
    a NaN or an infinity (one host read per tensor). Outputs that hold no
    data are skipped: fake and symbolic tensors, and anything made while
    ``torch.export`` traces or a CUDA graph captures (the JAX check is
    eager only too)."""
    from torch._subclasses.fake_tensor import FakeTensor

    if torch.compiler.is_compiling() or (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        return
    outs = out if isinstance(out, (tuple, list)) else (out,)
    with torch._C.DisableTorchFunctionSubclass():
        for o in outs:
            if (not isinstance(o, torch.Tensor) or isinstance(o, FakeTensor)
                    or getattr(type(o), "_symbolic", False)
                    or not (o.is_floating_point() or o.is_complex())):
                continue
            if not bool(torch.isfinite(o).all()):
                raise FloatingPointError(
                    f"op {name!r} produced nan/inf (FLAGS_check_nan_inf)")


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
        if CHECK_NAN_INF[0]:
            check_finite(getattr(func, "__name__", str(func)), out)
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

    @property
    def name(self):
        """Paddle's tensor name: None until one is set (torch's own
        ``name`` is read-only)."""
        return self.__dict__.get("_paddle_name")

    @name.setter
    def name(self, value) -> None:
        self.__dict__["_paddle_name"] = value

    def numpy(self) -> np.ndarray:
        return to_numpy(self)

    def astype(self, dtype) -> "Tensor":
        return self.to(_dt.convert_dtype(dtype))

    def clear_grad(self) -> None:
        self.grad = None

    def clear_gradient(self, set_to_zero: bool = False) -> None:
        """Drop the gradient, or with ``set_to_zero`` replace it by
        zeros."""
        if set_to_zero and self.grad is not None:
            self.grad = torch.zeros_like(self.grad)
        else:
            self.grad = None

    zero_grad = clear_grad

    @torch.no_grad()
    def set_value(self, value) -> "Tensor":
        """Copy ``value`` (a tensor, array or list of this tensor's
        size) into this tensor in place, in its shape, dtype and
        device."""
        src = value.detach() if isinstance(value, torch.Tensor) \
            else from_numpy(np.asarray(value))
        self.copy_(src.reshape(self.shape).to(self.dtype))
        return self

    def __deepcopy__(self, memo):
        """A copy with storage of its own, as torch's default makes one
        (torch's refuses a subclass whose ops return the subclass):
        values, ``requires_grad``, the gradient and the attributes."""
        if isinstance(self, torch.nn.Parameter):
            return torch.nn.Parameter.__deepcopy__(self, memo)
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad():
            out = torch.Tensor.clone(self).as_subclass(type(self))
        out.requires_grad_(self.requires_grad)
        memo[id(self)] = out
        if self.grad is not None:
            out.grad = copy.deepcopy(self.grad, memo)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def tpu(self) -> "Tensor":
        """This tensor on the card: in the JAX package ``tpu()`` and
        ``cuda()`` both mean the accelerator, which here is the GPU."""
        return self.to(to_torch_device("gpu"))


def _top(name: str):
    """The port's top-level function ``name`` (else ``linalg``'s)."""
    import paddle_tpu_torch as paddle

    fn = getattr(paddle, name, None)
    return fn if fn is not None else getattr(paddle.linalg, name)


def _paddle_method(name: str, fn: str):
    def method(self, *args, **kwargs):
        return _top(fn)(self, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = f"``paddle.{fn}(self, ...)``."
    return method


def _paddle_inplace(name: str, fn: str):
    """Paddle's in-place ``name``: the tensor takes the shape and values
    of ``paddle.<fn>(self, ...)`` (the JAX package rebinds its array)."""
    def method(self, *args, **kwargs):
        from ..ops.manipulation import _inplace

        return _inplace(self, _top(fn)(self, *args, **kwargs))

    method.__name__ = name
    method.__doc__ = f"``paddle.{fn}(self, ...)``, in place."
    return method


# the methods that are a top-level function with the tensor first
_BOUND = {name: name for name in (
    "cast scale reshape_ gather_nd scatter_nd scatter_nd_add "
    "take_along_axis put_along_axis index_sample concat stack unstack "
    "slice strided_slice pad reverse mod floor_mod tensordot multi_dot "
    "greater_than less_than equal_all is_empty is_integer is_tensor rank "
    "increment bucketize stanh cond eigvals eigvalsh lu_unpack multiplex "
    "shard_index add_n as_complex as_real broadcast_shape "
    "broadcast_tensors create_parameter create_tensor").split()}
_BOUND["numel_t"] = "numel"
for _name, _fn in _BOUND.items():
    setattr(Tensor, _name, _paddle_method(_name, _fn))
_IN_PLACE = {"scale_": "scale", "flatten_": "flatten",
             "put_along_axis_": "put_along_axis", "floor_mod_": "remainder"}
for _name, _fn in _IN_PLACE.items():
    setattr(Tensor, _name, _paddle_inplace(_name, _fn))
# Paddle's methods that torch does not define (those torch does define
# keep torch's meaning)
PADDLE_METHODS = tuple(_BOUND) + tuple(_IN_PLACE) + (
    "set_value", "clear_gradient", "zero_grad", "tpu")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Any torch tensor's values as numpy, from any device; bfloat16
    comes back as float32 (numpy has no bfloat16); a lazily conjugated
    or negated view (``torch.fft.ihfft``'s result) is resolved first."""
    t = t.detach().resolve_conj().resolve_neg()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return torch.Tensor.numpy(t.cpu().as_subclass(torch.Tensor))


def as_tensor(t: torch.Tensor, stop_gradient: bool = True) -> Tensor:
    """``t`` (a torch tensor that tracks no gradient) as a leaf ``Tensor``
    sharing its storage. Under ``torch.export`` (which traces plain
    tensors) and for a tensor of another subclass (a fake tensor) it is
    ``t`` as it is."""
    if torch.compiler.is_exporting() or (
            type(t) is not torch.Tensor and not isinstance(t, Tensor)):
        return t
    out = t.as_subclass(Tensor)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A torch copy of a numpy array, bfloat16 included: numpy's
    ``bfloat16`` extension type (what the JAX package's bfloat16 arrays
    become) and the port's ``dtypes.BFLOAT16_NP``."""
    arr = np.asarray(arr)
    if _dt.is_bfloat16_np(arr):
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
    if torch.compiler.is_exporting():
        return t                # a constant of the exported program
    return as_tensor(t.as_subclass(torch.Tensor), stop_gradient)


def to_tensor_arg(x):
    """An op's positional argument as a tensor: tensors pass through,
    arrays, lists and numpy scalars are copied to the current device.
    Python numbers stay numbers (torch broadcasts them)."""
    if isinstance(x, torch.Tensor) or isinstance(x, (bool, int, float)):
        return x
    return to_tensor(x)
