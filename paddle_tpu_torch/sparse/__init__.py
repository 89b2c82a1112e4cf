"""``paddle.sparse``: COO and CSR tensors, their ops, and sparse layers.

Counterpart of ``paddle_tpu/sparse/__init__.py`` and its design: a
sparse tensor is (indices, values) where the values are an ordinary
autograd tensor, so gradients flow into them through torch's autograd
and sparse ops compose with dense ones. Structure ops (``to_sparse_coo``,
``coalesce``, the union of two patterns, transposes and reshapes of the
indices) run on the host in numpy, as the JAX package's do, so orders
and ties come out the same; the math runs on the values' device as
gathers and ``index_add`` (a sparse-dense product gathers the dense
rows of every nonzero, scales them, and sums them into their output
rows). ``torch.sparse`` is not used: its coalescing and autograd
coverage differ from the JAX package's.

On the port's ``Tensor``, ``to_sparse_coo(sparse_dim)`` and
``to_sparse_csr()`` return :class:`SparseCooTensor` /
:class:`SparseCsrTensor`, Paddle's meaning; a plain ``torch.Tensor``
keeps torch's methods of those names.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core.tensor import Tensor, to_numpy, to_tensor, to_tensor_arg

__all__ = [
    "SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
    "sparse_csr_tensor", "is_same_shape", "coalesce",
    # unary
    "abs", "sin", "tan", "asin", "atan", "sinh", "cosh", "tanh", "asinh",
    "atanh", "sqrt", "square", "log1p", "expm1", "relu", "relu6",
    "leaky_relu", "neg", "pow", "scale", "cast", "deg2rad", "rad2deg",
    # binary / multiary
    "add", "subtract", "multiply", "divide", "matmul", "masked_matmul",
    "addmm", "mv", "transpose", "reshape", "sum", "softmax",
    "nn",
]


def _index_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return to_tensor(np.asarray(x, np.int64), place=device)


def _on(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host index array as an int64 tensor on ``like``'s device."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(
        like.device)


def _set_stop_gradient(values: torch.Tensor, stop: bool) -> torch.Tensor:
    """``values`` with Paddle's ``stop_gradient`` set: a non-leaf that
    tracks a gradient is detached (torch cannot untrack it in place)."""
    if stop:
        if values.requires_grad and values.grad_fn is not None:
            return values.detach()
        values.requires_grad_(False)
    elif not values.requires_grad:
        values.requires_grad_(True)
    return values


class _Sparse:
    """What the two containers share: values, gradients, the host copy
    of the structure."""

    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def place(self):
        return self._values.device

    @property
    def stop_gradient(self):
        return not self._values.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v):
        self._values = _set_stop_gradient(self._values, bool(v))

    @property
    def grad(self):
        return self._values.grad

    def nnz(self) -> int:
        return int(self._values.shape[0])

    def values(self):
        return self._values

    def is_sparse(self) -> bool:
        return True

    def numpy(self):
        return self.to_dense().numpy()

    def backward(self, *a, **k):
        raise RuntimeError("call backward() on a dense result, not the "
                           "sparse container")

    def __repr__(self):
        return (f"{type(self).__name__}(shape={self._shape}, "
                f"nnz={self.nnz()}, dtype={self.dtype})")

    def __matmul__(self, other):
        return matmul(self, other)

    def matmul(self, other):
        return matmul(self, other)


class SparseCooTensor(_Sparse):
    """Coordinate format: ``indices [sparse_dim, nnz]`` and ``values
    [nnz, *dense_dims]``."""

    def __init__(self, indices, values, shape: Sequence[int],
                 coalesced: bool = False):
        self._values = values if isinstance(values, torch.Tensor) \
            else to_tensor(values)
        self._indices = _index_tensor(indices, self._values.device)
        self._indices.requires_grad_(False)
        self._shape = [int(s) for s in shape]
        self._coalesced = coalesced
        self._host = None

    def _idx(self) -> np.ndarray:
        """The indices on the host (read once)."""
        if self._host is None:
            self._host = to_numpy(self._indices).astype(np.int64)
        return self._host

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def sparse_dim(self) -> int:
        return int(self._indices.shape[0])

    @property
    def dense_dim(self) -> int:
        return len(self._shape) - self.sparse_dim

    def indices(self):
        return self._indices

    def is_sparse_coo(self) -> bool:
        return True

    def is_sparse_csr(self) -> bool:
        return False

    def to_dense(self):
        v = self._values
        out = torch.zeros(self._shape, dtype=v.dtype, device=v.device)
        sites = tuple(self._indices[i] for i in range(self.sparse_dim))
        return out.index_put(sites, v, accumulate=True)

    def to_sparse_csr(self) -> "SparseCsrTensor":
        if self.sparse_dim != 2 or self.dense_dim != 0:
            raise ValueError("to_sparse_csr supports 2-D COO")
        t = coalesce(self)
        idx = t._idx()
        crows = np.zeros(self._shape[0] + 1, np.int64)
        np.add.at(crows, idx[0] + 1, 1)
        crows = np.cumsum(crows)
        out = SparseCsrTensor(_on(crows, t._values), _on(idx[1], t._values),
                              t._values, self._shape)
        out._rows = idx[0]
        return out

    def to_sparse_coo(self, sparse_dim=None):
        return self

    def coalesce(self) -> "SparseCooTensor":
        return coalesce(self)

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return subtract(self, other)

    def __mul__(self, other):
        return multiply(self, other)

    def __truediv__(self, other):
        return divide(self, other)

    def __neg__(self):
        return neg(self)

    def transpose(self, perm):
        return transpose(self, perm)

    def reshape(self, shape):
        return reshape(self, shape)

    def detach(self):
        return SparseCooTensor(self._indices, self._values.detach(),
                               self._shape, self._coalesced)

    def astype(self, dtype):
        return cast(self, value_dtype=dtype)


class SparseCsrTensor(_Sparse):
    """CSR matrix: ``crows [rows + 1]``, ``cols [nnz]``, ``values
    [nnz]``; 2-D only."""

    def __init__(self, crows, cols, values, shape: Sequence[int]):
        self._values = values if isinstance(values, torch.Tensor) \
            else to_tensor(values)
        dev = self._values.device
        self._crows = _index_tensor(crows, dev)
        self._cols = _index_tensor(cols, dev)
        self._crows.requires_grad_(False)
        self._cols.requires_grad_(False)
        self._shape = [int(s) for s in shape]
        if len(self._shape) != 2:
            raise ValueError("SparseCsrTensor supports 2-D matrices")
        self._rows = None
        self._rows_dev = None

    def crows(self):
        return self._crows

    def cols(self):
        return self._cols

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def _row_ids(self) -> np.ndarray:
        """Each nonzero's row, on the host (made once)."""
        if self._rows is None:
            crows = to_numpy(self._crows).astype(np.int64)
            self._rows = np.repeat(np.arange(len(crows) - 1), np.diff(crows))
        return self._rows

    def _row_ids_on_device(self) -> torch.Tensor:
        if self._rows_dev is None:
            self._rows_dev = _on(self._row_ids(), self._values)
        return self._rows_dev

    def to_dense(self):
        v = self._values
        out = torch.zeros(self._shape, dtype=v.dtype, device=v.device)
        return out.index_put((self._row_ids_on_device(), self._cols), v,
                             accumulate=True)

    def to_sparse_coo(self, sparse_dim=2) -> SparseCooTensor:
        rows = self._row_ids()
        idx = np.stack([rows, to_numpy(self._cols).astype(np.int64)])
        out = SparseCooTensor(_on(idx, self._values), self._values,
                              self._shape, coalesced=True)
        out._host = idx
        return out

    def to_sparse_csr(self):
        return self


# -------------------------------------------------------------- creation ---


def _values_arg(values, dtype, place):
    vt = values if isinstance(values, torch.Tensor) \
        else to_tensor(np.asarray(values), place=place)
    if dtype is not None:
        from ..ops.math import cast as _cast

        vt = _cast(vt, dtype)
    return vt


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True) -> SparseCooTensor:
    """A COO tensor; ``shape`` defaults to one past each index's largest
    value, then the values' dense dims."""
    vt = _values_arg(values, dtype, place)
    it = _index_tensor(indices, vt.device)
    if shape is None:
        idx = to_numpy(it)
        shape = [int(idx[i].max()) + 1 if idx.size else 0
                 for i in range(idx.shape[0])] + list(vt.shape[1:])
    out = SparseCooTensor(it, vt, shape)
    out.stop_gradient = stop_gradient
    return out


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True) -> SparseCsrTensor:
    vt = _values_arg(values, dtype, place)
    out = SparseCsrTensor(_index_tensor(crows, vt.device),
                          _index_tensor(cols, vt.device), vt, shape)
    out.stop_gradient = stop_gradient
    return out


def coalesce(x: SparseCooTensor) -> SparseCooTensor:
    """Duplicate coordinates summed, sorted row-major (the structure on
    the host, the sums on the values' device)."""
    if x._coalesced:
        return x
    idx = x._idx()
    if idx.shape[1] == 0:
        return SparseCooTensor(x._indices, x._values, x._shape, True)
    dims = tuple(x._shape[:x.sparse_dim])
    flat = np.ravel_multi_index(tuple(idx), dims)
    uniq, inv = np.unique(flat, return_inverse=True)
    new_idx = np.stack(np.unravel_index(uniq, dims)).astype(np.int64)
    v = x._values
    vals = torch.zeros((len(uniq),) + tuple(v.shape[1:]), dtype=v.dtype,
                       device=v.device).index_add(0, _on(inv, v), v)
    out = SparseCooTensor(_on(new_idx, v), vals, x._shape, True)
    out._host = new_idx
    return out


def is_same_shape(x, y) -> bool:
    return list(x.shape) == list(y.shape)


# ----------------------------------------------------------------- unary ---


def _with_values(x, vals):
    if isinstance(x, SparseCooTensor):
        out = SparseCooTensor(x._indices, vals, x._shape, x._coalesced)
        out._host = x._host
        return out
    out = SparseCsrTensor(x._crows, x._cols, vals, x._shape)
    out._rows, out._rows_dev = x._rows, x._rows_dev
    return out


def _unary(name, fn):
    def op(x, *args, **kwargs):
        if not isinstance(x, _Sparse):
            raise TypeError(f"sparse.{name} expects a sparse tensor")
        return _with_values(x, fn(x._values, *args, **kwargs))

    op.__name__ = name
    return op


abs = _unary("abs", torch.abs)  # noqa: A001
sin = _unary("sin", torch.sin)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
atanh = _unary("atanh", torch.atanh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
log1p = _unary("log1p", torch.log1p)
expm1 = _unary("expm1", torch.expm1)
relu = _unary("relu", lambda v: torch.maximum(v, torch.zeros_like(v)))
relu6 = _unary("relu6", lambda v: torch.clamp(v, 0, 6))
neg = _unary("neg", torch.neg)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)


def leaky_relu(x, negative_slope=0.01):
    return _unary("leaky_relu", lambda v: torch.where(
        v >= 0, v, v * negative_slope))(x)


def pow(x, factor):  # noqa: A001
    return _unary("pow", lambda v: torch.pow(v, factor))(x)


def scale(x, scale_=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return _unary("scale", lambda v: v * scale_ + bias)(x)
    return _unary("scale", lambda v: (v + bias) * scale_)(x)


def cast(x, index_dtype=None, value_dtype=None):
    from ..core import dtypes as _dt

    out = x
    if value_dtype is not None:
        dt = _dt.convert_dtype(value_dtype)
        out = _unary("cast", lambda v: v.to(dt))(out)
    if index_dtype is not None:
        dt = _dt.convert_dtype(index_dtype)
        if isinstance(out, SparseCooTensor):
            out = SparseCooTensor(out._indices.to(dt), out._values,
                                  out._shape, out._coalesced)
        else:
            out = SparseCsrTensor(out._crows.to(dt), out._cols.to(dt),
                                  out._values, out._shape)
    return out


# ---------------------------------------------------------------- binary ---


def _binary(name, fn, x, y):
    """Sparse-sparse elementwise: identical patterns combine their
    values; otherwise both scatter into the union of the patterns (a
    host structure op) and combine there."""
    if isinstance(x, SparseCsrTensor) or isinstance(y, SparseCsrTensor):
        xc = x.to_sparse_coo() if isinstance(x, SparseCsrTensor) else x
        yc = y.to_sparse_coo() if isinstance(y, SparseCsrTensor) else y
        return _binary(name, fn, xc, yc).to_sparse_csr()
    if not (isinstance(x, SparseCooTensor) and isinstance(y, SparseCooTensor)):
        raise TypeError(f"sparse.{name} expects two sparse tensors")
    if list(x._shape) != list(y._shape):
        raise ValueError(f"sparse.{name}: shape mismatch {x._shape} vs "
                         f"{y._shape}")
    x = coalesce(x)
    y = coalesce(y)
    xi, yi = x._idx(), y._idx()
    if xi.shape == yi.shape and np.array_equal(xi, yi):
        out = SparseCooTensor(x._indices, fn(x._values, y._values),
                              x._shape, True)
        out._host = xi
        return out
    sp = tuple(x._shape[:x.sparse_dim])
    fx = np.ravel_multi_index(tuple(xi), sp)
    fy = np.ravel_multi_index(tuple(yi), sp)
    uni = np.union1d(fx, fy)
    new_idx = np.stack(np.unravel_index(uni, sp)).astype(np.int64)
    xv, yv = x._values, y._values
    rest = tuple(xv.shape[1:])
    xs = torch.zeros((len(uni),) + rest, dtype=xv.dtype,
                     device=xv.device).index_copy(
        0, _on(np.searchsorted(uni, fx), xv), xv)
    ys = torch.zeros((len(uni),) + rest, dtype=yv.dtype,
                     device=yv.device).index_copy(
        0, _on(np.searchsorted(uni, fy), yv), yv)
    out = SparseCooTensor(_on(new_idx, xv), fn(xs, ys), x._shape, True)
    out._host = new_idx
    return out


def add(x, y):
    return _binary("add", torch.add, x, y)


def subtract(x, y):
    return _binary("subtract", torch.subtract, x, y)


def multiply(x, y):
    if isinstance(y, (int, float)):
        return scale(x, float(y))
    return _binary("multiply", torch.multiply, x, y)


def divide(x, y):
    if isinstance(y, (int, float)):
        return scale(x, 1.0 / float(y))
    # dividing by an implicit zero is undefined: the patterns must match
    xc = coalesce(x.to_sparse_coo() if isinstance(x, SparseCsrTensor) else x)
    yc = coalesce(y.to_sparse_coo() if isinstance(y, SparseCsrTensor) else y)
    if not np.array_equal(xc._idx(), yc._idx()):
        raise ValueError(
            "sparse.divide requires identical sparsity patterns (division "
            "by an implicit zero is undefined)")
    out = _binary("divide", torch.divide, xc, yc)
    if isinstance(x, SparseCsrTensor):
        return out.to_sparse_csr()
    return out


# --------------------------------------------------------------- matmul ----


def _gather_sum(values, dense, cols, rows, n_rows):
    """``out[r] = sum over the nonzeros (r, c, v) of v * dense[c]``: the
    dense rows gathered per nonzero, scaled, and added into their output
    rows."""
    gathered = values[:, None] * torch.index_select(dense, 0, cols)
    out = torch.zeros((n_rows, dense.shape[1]), dtype=gathered.dtype,
                      device=gathered.device)
    return out.index_add(0, rows, gathered)


def matmul(x, y):
    """sparse @ dense -> dense (COO or CSR)."""
    if isinstance(y, _Sparse):
        raise NotImplementedError("sparse @ sparse is not supported; "
                                  "use masked_matmul for masked outputs")
    yt = to_tensor_arg(y)
    if isinstance(x, SparseCsrTensor):
        return _gather_sum(x._values, yt, x._cols, x._row_ids_on_device(),
                           x._shape[0])
    if isinstance(x, SparseCooTensor):
        if x.sparse_dim != 2 or x.dense_dim != 0:
            raise ValueError("matmul supports 2-D sparse matrices")
        return _gather_sum(x._values, yt, x._indices[1], x._indices[0],
                           x._shape[0])
    raise TypeError("matmul expects a sparse lhs")


def masked_matmul(x, y, mask):
    """``x @ y`` evaluated only at ``mask``'s pattern (SDDMM): for each
    nonzero (r, c), ``x[r] . y[:, c]``."""
    if isinstance(mask, SparseCsrTensor):
        coo = mask.to_sparse_coo()
        out = masked_matmul(x, y, coo)
        return _with_values(mask, out._values)
    if not isinstance(mask, SparseCooTensor):
        raise TypeError("mask must be sparse")
    xt, yt = to_tensor_arg(x), to_tensor_arg(y)
    idx = mask._indices
    vals = (torch.index_select(xt, 0, idx[0])
            * torch.index_select(yt, 1, idx[1]).t()).sum(-1)
    out = SparseCooTensor(idx, vals, mask._shape, mask._coalesced)
    out._host = mask._host
    return out


def addmm(input, x, y, beta=1.0, alpha=1.0):
    """``beta * input + alpha * (x @ y)``; x sparse, input and y dense."""
    from ..ops import math as _m

    return _m.add(_m.scale(to_tensor_arg(input), beta),
                  _m.scale(matmul(x, y), alpha))


def mv(x, vec):
    """Sparse matrix @ dense vector."""
    return matmul(x, to_tensor_arg(vec).reshape(-1, 1)).reshape(-1)


# ------------------------------------------------------------ structure ----


def transpose(x: SparseCooTensor, perm):
    if not isinstance(x, SparseCooTensor):
        raise TypeError("transpose supports COO")
    if sorted(perm) != list(range(x.sparse_dim)) or x.dense_dim != 0:
        raise ValueError("transpose permutes sparse dims of an all-sparse "
                         "COO")
    idx = x._idx()[list(perm)]
    out = SparseCooTensor(_on(idx, x._values), x._values,
                          [x._shape[p] for p in perm])
    out._host = idx
    return out


def reshape(x: SparseCooTensor, shape):
    if not isinstance(x, SparseCooTensor) or x.dense_dim != 0:
        raise TypeError("reshape supports all-sparse COO")
    old = tuple(x._shape)
    numel = int(np.prod(old))
    if any(s == -1 for s in shape):
        known = int(np.prod([s for s in shape if s != -1]))
        shape = [numel // known if s == -1 else s for s in shape]
    new = tuple(int(s) for s in shape)
    flat = np.ravel_multi_index(tuple(x._idx()), old)
    nidx = np.stack(np.unravel_index(flat, new)).astype(np.int64)
    out = SparseCooTensor(_on(nidx, x._values), x._values, list(new))
    out._host = nidx
    return out


def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    """Sum of the densified tensor (a dense result)."""
    from ..ops import reduction as _r
    from ..ops.math import cast as _cast

    out = _r.sum(x.to_dense(), axis=axis, keepdim=keepdim)
    return _cast(out, dtype) if dtype is not None else out


def softmax(x, axis=-1):
    """Row softmax over the nonzeros of each row."""
    if isinstance(x, SparseCsrTensor):
        out = softmax(x.to_sparse_coo(), axis)
        return _with_values(x, out._values)
    if not isinstance(x, SparseCooTensor) or x.sparse_dim != 2:
        raise ValueError("sparse.softmax supports 2-D sparse tensors")
    if axis not in (-1, 1):
        raise ValueError("sparse.softmax is over the last axis")
    xc = coalesce(x)
    v = xc._values
    rows = xc._indices[0]
    n_rows = x._shape[0]
    rmax = torch.zeros(n_rows, dtype=v.dtype, device=v.device).scatter_reduce(
        0, rows, v, "amax", include_self=False)
    e = torch.exp(v - rmax[rows])
    denom = torch.zeros(n_rows, dtype=v.dtype, device=v.device).index_add(
        0, rows, e)
    out = SparseCooTensor(xc._indices, e / denom[rows], x._shape, True)
    out._host = xc._host
    return out


# ------------------------------------------ the port Tensor's methods ------


def _dense_to_sparse_coo(self, sparse_dim: int) -> SparseCooTensor:
    """The nonzeros of the tensor (over its first ``sparse_dim`` dims;
    a site counts when any of its trailing dense entries is nonzero),
    found on the host; the values are gathered on the device."""
    arr = to_numpy(self)
    red = arr
    if sparse_dim < arr.ndim:
        red = np.abs(arr).sum(tuple(range(sparse_dim, arr.ndim)))
    idx = np.stack(np.nonzero(red)).astype(np.int64)
    dev_idx = _on(idx, self)
    vals = self[tuple(dev_idx[i] for i in range(sparse_dim))]
    out = SparseCooTensor(dev_idx, vals, list(arr.shape))
    out._host = idx
    return out


def _dense_to_sparse_csr(self) -> SparseCsrTensor:
    return _dense_to_sparse_coo(self, 2).to_sparse_csr()


Tensor.to_sparse_coo = _dense_to_sparse_coo
Tensor.to_sparse_csr = _dense_to_sparse_csr

from . import nn  # noqa: E402,F401
