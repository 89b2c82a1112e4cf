"""Reductions and search with Paddle's ``axis``/``keepdim`` (counterpart
of ``paddle_tpu/ops/reduction.py``); ``axis=None`` reduces every axis.
Like the JAX package's, these are not entered in the op registry.

``median`` is ``jnp.median``'s: the mean of the two middle values of an
even count (``torch.median`` takes the lower one). ``sort``, ``argsort``
and ``kthvalue`` sort stably, and a descending sort is the ascending one
reversed, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core.tensor import to_tensor_arg

__all__ = ["sum", "mean", "max", "min", "prod", "amax", "amin", "nansum",
           "nanmean", "all", "any", "logsumexp", "std", "var", "median",
           "quantile", "argmax", "argmin", "topk", "sort", "argsort",
           "kthvalue", "mode", "count_nonzero"]


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    return (tuple(int(a) for a in axis) if isinstance(axis, (list, tuple))
            else (int(axis),))


def _reduce(fn, x, axis, keepdim):
    """``fn`` over ``axis``: None reduces every axis, an empty list or
    tuple none (x comes back unchanged, as ``jnp.sum(x, axis=())``
    does; torch would read ``dim=()`` as every axis)."""
    x = to_tensor_arg(x)
    dim = _axis(axis)
    if dim == ():
        return fn(x.unsqueeze(0), dim=0)
    return fn(x, dim=() if dim is None else dim, keepdim=keepdim)


def _to_last(x, axis):
    """x with the ``axis`` axes (None: all) flattened into one last axis,
    and a function that puts a reduced result back in keepdim form."""
    dims = tuple(range(x.ndim)) if axis is None else tuple(
        a % x.ndim for a in axis)
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(*rest, *dims).reshape(
        *[x.shape[d] for d in rest], -1)

    def keep(r, lead=0):
        shape = list(r.shape[:lead]) + [1 if d in dims else x.shape[d]
                                        for d in range(x.ndim)]
        return r.reshape(shape)
    return moved, keep


def _over_last(fn, x, axis, keepdim, lead=0):
    """``fn(moved)`` reduces the last axis of x's ``axis`` axes gathered
    at the end; the result keeps or drops them."""
    x = to_tensor_arg(x)
    dim = _axis(axis)
    if dim == ():
        return x
    moved, keep = _to_last(x, dim)
    out = fn(moved)
    return keep(out, lead) if keepdim else out


def sum(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _reduce(torch.sum, x, axis, keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    """The mean of an integer or bool tensor is float32, as
    ``jnp.mean``'s."""
    x = to_tensor_arg(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return _reduce(torch.mean, x, axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _reduce(torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _reduce(torch.amin, x, axis, keepdim)


amax, amin = max, min


def prod(x, axis=None, keepdim=False, name=None):
    return _over_last(lambda m: torch.prod(m, -1), x, axis, keepdim)


def nansum(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.nansum, x, axis, keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.nanmean, x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _over_last(lambda m: torch.all(m, -1), x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001 - Paddle's name
    return _over_last(lambda m: torch.any(m, -1), x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = to_tensor_arg(x)
    dim = _axis(axis)
    if dim == ():
        return x
    return torch.logsumexp(x, dim=tuple(range(x.ndim)) if dim is None
                           else dim, keepdim=keepdim)


def _float(x):
    x = to_tensor_arg(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(lambda t, dim, keepdim=False: torch.std(
        t, dim=dim or None, correction=int(unbiased), keepdim=keepdim),
        _float(x), axis, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(lambda t, dim, keepdim=False: torch.var(
        t, dim=dim or None, correction=int(unbiased), keepdim=keepdim),
        _float(x), axis, keepdim)


def _midpoint(m):
    """``jnp.median`` of the last axis: the mean of its two middle values
    (one value for an odd count)."""
    s = torch.sort(m, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) / 2


def median(x, axis=None, keepdim=False, name=None):
    return _over_last(_midpoint, _float(x), axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Linear interpolation (``jnp.quantile``'s default); a list of q
    puts them on a new first axis."""
    x = _float(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return _over_last(lambda m: torch.quantile(m, qt, dim=-1), x, axis,
                      keepdim, lead=qt.ndim)


def _arg(fn, x, axis, keepdim, dtype):
    x = to_tensor_arg(x)
    if axis is None:
        out = fn(x.reshape(-1))
    else:
        out = fn(x, dim=int(_axis(axis)[0]), keepdim=keepdim)
    return out.to(_dt.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first index of the maximum (flattened without ``axis``)."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def topk(x, k, axis=-1, largest=True, sorted=True,  # noqa: A002
         name=None):
    x = to_tensor_arg(x)
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    vals, idx = torch.topk(x, int(k), dim=axis, largest=largest,
                           sorted=True)
    return vals, idx


def _sort(x, axis, descending):
    vals, idx = torch.sort(to_tensor_arg(x), dim=axis, stable=True)
    if descending:
        vals, idx = torch.flip(vals, (axis,)), torch.flip(idx, (axis,))
    return vals, idx


def sort(x, axis=-1, descending=False, name=None):
    return _sort(x, axis, descending)[0]


def argsort(x, axis=-1, descending=False, name=None):
    return _sort(x, axis, descending)[1]


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    vals, idx = _sort(x, axis, False)
    vals, idx = (t.narrow(axis, k - 1, 1) for t in (vals, idx))
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of equally
    frequent ones) and the index of its first occurrence, as the JAX
    package's run-length form picks them."""
    x = to_tensor_arg(x)
    axis = axis % x.ndim
    v = torch.movedim(x, axis, -1)
    s = torch.sort(v, dim=-1).values
    counts = (s[..., :, None] == s[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    vals = torch.take_along_dim(s, best, -1)
    idx = torch.argmax((v == vals).to(torch.int8), dim=-1, keepdim=True)
    if keepdim:
        return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)
    return vals[..., 0], idx[..., 0]


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda t, dim, keepdim=False: torch.sum(
        t != 0, dim=dim, keepdim=keepdim), x, axis, keepdim)
