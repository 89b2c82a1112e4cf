"""Creation ops (counterpart of ``paddle_tpu/ops/creation.py``): each
returns a leaf ``Tensor`` on the current device (the ``*_like`` ops on
their input's). The random draws are in ``random_ops.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.device import current_device, to_torch_device
from ..core.tensor import as_tensor as _leaf
from ..core.tensor import to_tensor, to_tensor_arg

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "diag", "diagflat", "tril", "triu",
           "meshgrid", "assign", "clone", "one_hot", "tril_indices",
           "triu_indices", "complex_", "as_tensor", "create_tensor"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return [int(s) for s in shape] if isinstance(shape, (list, tuple)) \
        else [int(shape)]


def _dtype(dtype):
    return _dt.convert_dtype(dtype) or _dt.get_default_dtype()


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def full(shape, fill_value, dtype=None, name=None):
    """Without ``dtype``, the fill value's type picks it, as in the JAX
    package: bool gives bool, int gives int64 (the port's integer
    default), anything else the default float dtype."""
    fill_value = _item(fill_value)
    if dtype is None:
        dtype = (_dt.bool_ if isinstance(fill_value, bool)
                 else _dt.int64 if isinstance(fill_value, int)
                 else _dt.get_default_dtype())
    return _leaf(torch.full(_shape(shape), fill_value, dtype=_dtype(dtype),
                            device=current_device()))


def zeros(shape, dtype=None, name=None):
    return full(shape, 0, _dtype(dtype))


def ones(shape, dtype=None, name=None):
    return full(shape, 1, _dtype(dtype))


def empty(shape, dtype=None, name=None):
    """Zeros, as the JAX package's ``empty`` (an XLA array has no
    uninitialised state)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = to_tensor_arg(x)
    return _leaf(torch.zeros_like(x, dtype=_dt.convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    x = to_tensor_arg(x)
    return _leaf(torch.ones_like(x, dtype=_dt.convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    x = to_tensor_arg(x)
    return _leaf(torch.full_like(x, _item(fill_value),
                                 dtype=_dt.convert_dtype(dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """Integers (int64) when every bound is an int, else the default
    float dtype, as in the JAX package."""
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (_dt.int64 if all(isinstance(v, (int, np.integer))
                                  for v in (start, end, step))
                 else _dt.get_default_dtype())
    return _leaf(torch.arange(start, end, step,
                              dtype=_dt.convert_dtype(dtype),
                              device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _leaf(torch.linspace(_item(start), _item(stop), int(_item(num)),
                                dtype=_dtype(dtype),
                                device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _leaf(torch.logspace(_item(start), _item(stop), int(_item(num)),
                                base=_item(base), dtype=_dtype(dtype),
                                device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _leaf(torch.eye(int(num_rows), int(num_columns or num_rows),
                           dtype=_dtype(dtype), device=current_device()))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-d x becomes a matrix with x on diagonal ``offset`` (the rest
    ``padding_value``); a 2-d x gives that diagonal."""
    x = to_tensor_arg(x)
    if padding_value != 0 and x.ndim == 1:
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        return base + torch.diag(x - padding_value, offset)
    return torch.diag(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diag(to_tensor_arg(x).reshape(-1), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(to_tensor_arg(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(to_tensor_arg(x), diagonal)


def meshgrid(*args, **kwargs):
    """``ij``-indexed grids of the given 1-d tensors (a list works too)."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*[to_tensor_arg(a) for a in args],
                               indexing="ij"))


def assign(x, output=None):
    """A copy of x (differentiable); with ``output``, written into it."""
    x = to_tensor_arg(x)
    out = x.clone() if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x):
    return assign(x)


def one_hot(x, num_classes, name=None):
    """``[..., num_classes]`` in the default float dtype; an id outside
    ``[0, num_classes)`` gives a row of zeros (``jax.nn.one_hot``)."""
    x = to_tensor_arg(x).long()
    classes = torch.arange(int(num_classes), device=x.device)
    return (x[..., None] == classes).to(_dt.get_default_dtype())


def _indices(fn, row, col, offset, dtype):
    col = row if col is None else col
    r, c = fn(row, k=offset, m=col)
    return _leaf(torch.as_tensor(np.stack([r, c]),
                                 dtype=_dt.convert_dtype(dtype),
                                 device=current_device()))


def tril_indices(row, col=None, offset=0, dtype=_dt.int64):
    return _indices(np.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype=_dt.int64):
    return _indices(np.triu_indices, row, col, offset, dtype)


def complex_(real, imag, name=None):
    return torch.complex(to_tensor_arg(real), to_tensor_arg(imag))


def as_tensor(data, dtype=None, place=None):
    return to_tensor(data, dtype=dtype, place=place)


def create_tensor(dtype="float32", name=None, persistable=False):
    """A zero scalar of ``dtype`` (a tensor: its dtype), to be assigned
    later."""
    if isinstance(dtype, torch.Tensor):
        dtype = dtype.dtype
    t = to_tensor(torch.zeros((), dtype=_dt.convert_dtype(dtype)),
                  place=to_torch_device(None))
    if name:
        t.name = name
    return t
