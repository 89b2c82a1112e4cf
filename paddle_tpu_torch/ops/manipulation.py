"""Shape, indexing, gather/scatter and padding ops with Paddle's
arguments (counterpart of ``paddle_tpu/ops/manipulation.py``):
``transpose`` takes a full permutation, ``concat``/``stack`` an
``axis``. The ops the JAX package enters in its registry under a fixed
name are entered under the same names.

The JAX package computes ``masked_select``, ``nonzero``, ``unique`` and
a tensor-``repeats`` ``repeat_interleave`` on the host (their output
shapes depend on the data); here they run on the tensor's device, and
read back only the one size their output needs.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtypes as _dt
from ..core.dispatch import defop
from ..core.tensor import as_tensor, to_tensor_arg

__all__ = ["reshape", "reshape_", "view", "flatten", "transpose", "t",
           "moveaxis", "swapaxes", "concat", "stack", "split", "chunk",
           "unbind", "squeeze", "squeeze_", "unsqueeze", "unsqueeze_",
           "tile", "broadcast_to", "expand", "expand_as",
           "broadcast_tensors", "broadcast_shape", "flip", "roll", "rot90",
           "slice", "strided_slice", "gather", "gather_nd",
           "take_along_axis", "put_along_axis", "scatter", "scatter_",
           "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
           "index_add", "index_put", "where", "masked_select",
           "masked_fill", "nonzero", "unique", "unique_consecutive",
           "repeat_interleave", "pad", "crop", "shard_index", "as_real",
           "as_complex", "numel", "shape", "is_tensor"]

_slice = builtins.slice


def _ints(shape):
    if isinstance(shape, torch.Tensor):
        return [int(v) for v in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def _axis(axis):
    return int(axis.item()) if isinstance(axis, torch.Tensor) else axis


@defop("reshape")
def _reshape(x, shape=()):
    return x.reshape(shape)


def reshape(x, shape, name=None):
    return _reshape(x, shape=_ints(shape))


def _inplace(x, out):
    """Paddle's in-place shape ops: ``x`` takes ``out``'s shape and
    values (the JAX package rebinds its Tensor's array)."""
    x.data = out.detach()
    return x


def reshape_(x, shape, name=None):
    return _inplace(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return to_tensor_arg(x).to(_dt.convert_dtype(shape_or_dtype))


@defop("flatten")
def _flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis) if x.ndim else \
        x.reshape(1)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten(x, start_axis=start_axis, stop_axis=stop_axis)


@defop("transpose")
def _transpose(x, perm=()):
    return x.permute(perm)


def transpose(x, perm, name=None):
    return _transpose(x, perm=[int(p) for p in perm])


def t(x, name=None):
    x = to_tensor_arg(x)
    return x if x.ndim < 2 else x.permute(*range(x.ndim - 1, -1, -1))


@defop("moveaxis")
def _moveaxis(x, source=0, destination=0):
    return torch.movedim(x, source, destination)


def moveaxis(x, source, destination, name=None):
    return _moveaxis(x, source=source, destination=destination)


@defop("swapaxes")
def _swapaxes(x, axis1=0, axis2=1):
    return torch.swapaxes(x, axis1, axis2)


def swapaxes(x, axis1, axis2, name=None):
    return _swapaxes(x, axis1=axis1, axis2=axis2)


def concat(x, axis=0, name=None):
    return torch.cat([to_tensor_arg(a) for a in x], int(_axis(axis)))


def stack(x, axis=0, name=None):
    return torch.stack([to_tensor_arg(a) for a in x], int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """Equal parts (the size must divide) or the given sizes, one of
    which may be -1 (the rest)."""
    x = to_tensor_arg(x)
    axis = int(_axis(axis))
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"split: axis {axis} size {dim} is not "
                             f"divisible by num_or_sections="
                             f"{num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        known = builtins.sum(s for s in sizes if s >= 0)
        sizes = [s if s >= 0 else dim - known for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(to_tensor_arg(x), int(axis)))


@defop("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(a for a in axis if x.shape[a] == 1))


def squeeze(x, axis=None, name=None):
    if axis is not None and not isinstance(axis, (list, tuple)):
        axis = [axis]
    return _squeeze(x, axis=None if axis is None else [int(a) for a in axis])


def squeeze_(x, axis=None, name=None):
    return _inplace(x, squeeze(x, axis))


@defop("unsqueeze")
def _unsqueeze(x, axis=()):
    for a in sorted(a % (x.ndim + len(axis)) for a in axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    return _unsqueeze(x, axis=[int(a) for a in axis])


def unsqueeze_(x, axis, name=None):
    return _inplace(x, unsqueeze(x, axis))


@defop("tile")
def _tile(x, repeat_times=()):
    return torch.tile(x, tuple(repeat_times))


def tile(x, repeat_times, name=None):
    return _tile(x, repeat_times=_ints(repeat_times))


@defop("broadcast_to")
def _broadcast_to(x, shape=()):
    return torch.broadcast_to(x, tuple(shape))


def broadcast_to(x, shape, name=None):
    return _broadcast_to(x, shape=_ints(shape))


def expand(x, shape, name=None):
    """``broadcast_to`` where -1 keeps the input's size."""
    x = to_tensor_arg(x)
    shape = _ints(shape)
    cur = [1] * (len(shape) - x.ndim) + list(x.shape)
    return broadcast_to(x, [c if s == -1 else s for s, c in zip(shape, cur)])


def expand_as(x, y, name=None):
    return broadcast_to(x, list(to_tensor_arg(y).shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[to_tensor_arg(t) for t in inputs]))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@defop("flip")
def _flip(x, axis=()):
    return torch.flip(x, tuple(axis))


def flip(x, axis, name=None):
    axis = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return _flip(x, axis=[int(a) for a in axis])


@defop("roll")
def _roll(x, shifts=0, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, (list, tuple)):
        shifts = tuple(shifts)
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _roll(x, shifts=shifts, axis=axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(to_tensor_arg(x), k, list(axes))


# ---------------------------------------------------------------- slicing --


def slice(x, axes, starts, ends, name=None):  # noqa: A001 - Paddle's name
    x = to_tensor_arg(x)
    idx = [_slice(None)] * x.ndim
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = _slice(int(_axis(s)), int(_axis(e)))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis; a negative stride walks backwards, as
    numpy's does (torch's slicing takes positive steps only)."""
    x = to_tensor_arg(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        n = x.shape[ax]
        idx = list(range(n))[_slice(int(s), int(e), int(st))]
        x = torch.index_select(x, ax, torch.tensor(idx, dtype=torch.long,
                                                   device=x.device))
    return x


# --------------------------------------------------------- gather/scatter --


@defop("gather")
def _gather(x, index, axis=0):
    return torch.index_select(x, axis, index.reshape(-1).long())


def gather(x, index, axis=0, name=None):
    """Rows of x at ``index`` (flattened) along ``axis``."""
    return _gather(x, index, axis=int(_axis(axis)))


@defop("gather_nd")
def _gather_nd(x, index):
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def gather_nd(x, index, name=None):
    return _gather_nd(x, index)


def take_along_axis(arr, indices, axis, name=None):
    return torch.take_along_dim(to_tensor_arg(arr),
                                to_tensor_arg(indices).long(), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """x with ``values`` written at ``indices`` along ``axis``
    (``assign``, ``add``, ``multiply``/``mul``)."""
    x, idx = to_tensor_arg(arr), to_tensor_arg(indices).long()
    v = torch.broadcast_to(torch.as_tensor(to_tensor_arg(values),
                                           device=x.device),
                           idx.shape).to(x.dtype)
    axis = int(axis)
    if reduce == "assign":
        return torch.scatter(x, axis, idx, v)
    if reduce == "add":
        return torch.scatter_add(x, axis, idx, v)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(x, axis, idx, v, "prod")
    raise ValueError(f"unknown reduce mode {reduce}")


def scatter(x, index, updates, overwrite=True, name=None):
    """Row scatter along axis 0 (``[N]`` or ``[N, 1]`` ids):
    ``overwrite`` writes the rows; otherwise the rows named are zeroed
    and every update added (duplicates sum)."""
    x, idx, upd = (to_tensor_arg(a) for a in (x, index, updates))
    idx = (idx[:, 0] if idx.ndim == 2 else idx).long()
    upd = upd.to(x.dtype)
    if overwrite:
        return torch.index_copy(x, 0, idx, upd)
    return torch.index_add(torch.index_fill(x, 0, idx, 0), 0, idx, upd)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    x, idx, upd = (to_tensor_arg(a) for a in (x, index, updates))
    return torch.index_put(x, tuple(torch.movedim(idx.long(), -1, 0)),
                           upd.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    upd = to_tensor_arg(updates)
    base = torch.zeros(_ints(shape), dtype=upd.dtype, device=upd.device)
    return scatter_nd_add(base, index, upd)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index):
    return torch.take_along_dim(to_tensor_arg(x),
                                to_tensor_arg(index).long(), 1)


def index_add(x, index, axis, value, name=None):
    x = to_tensor_arg(x)
    return torch.index_add(x, int(axis), to_tensor_arg(index).long(),
                           to_tensor_arg(value).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = to_tensor_arg(x)
    idx = tuple(to_tensor_arg(i) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    v = torch.as_tensor(to_tensor_arg(value), device=x.device).to(x.dtype)
    return torch.index_put(x, idx, v, accumulate=accumulate)


# ------------------------------------------------------------ where/select --


def where(condition, x=None, y=None, name=None):
    cond = to_tensor_arg(condition)
    if x is None and y is None:
        return nonzero(cond, as_tuple=True)
    return torch.where(cond, to_tensor_arg(x), to_tensor_arg(y))


def masked_select(x, mask, name=None):
    """The elements of x where ``mask`` (broadcast) is true, as 1-d."""
    x, mask = to_tensor_arg(x), to_tensor_arg(mask)
    return torch.masked_select(x, mask.bool())


def masked_fill(x, mask, value, name=None):
    x, mask = to_tensor_arg(x), to_tensor_arg(mask)
    v = value.item() if isinstance(value, torch.Tensor) else value
    return torch.where(mask.bool(), torch.tensor(v, dtype=x.dtype,
                                                 device=x.device), x)


def nonzero(x, as_tuple=False):
    x = to_tensor_arg(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype=_dt.int64, name=None):
    """``np.unique``'s outputs (sorted values, then first indices,
    inverse and counts as asked), on x's device."""
    x = to_tensor_arg(x)
    flat = x.reshape(-1) if axis is None else x
    vals, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = flat.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.long, device=x.device)
        out.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype=_dt.int64, name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive(axis=...) is not "
                                  "ported (nor in the JAX package)")
    res = torch.unique_consecutive(to_tensor_arg(x).reshape(-1),
                                   return_inverse=return_inverse,
                                   return_counts=return_counts)
    return res if isinstance(res, torch.Tensor) or len(res) > 1 else res[0]


def repeat_interleave(x, repeats, axis=None, name=None):
    x = to_tensor_arg(x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    else:
        repeats = int(repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


# -------------------------------------------------------------------- pad --


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a padded axis: numpy's ``reflect`` (the edge
    not repeated), ``edge`` (replicate) or ``wrap`` (circular)."""
    i = np.arange(-lo, n + hi)
    if mode == "replicate":
        j = np.clip(i, 0, n - 1)
    elif mode == "circular":
        j = np.mod(i, n)
    else:
        period = 2 * (n - 1)
        j = np.mod(i, period) if period else np.zeros_like(i)
        j = np.where(j >= n, period - j, j)
    return torch.as_tensor(j, dtype=torch.long, device=device)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """Paddle's pad. With ``2 * ndim`` entries: ``[before0, after0,
    before1, after1, ...]`` over every axis. Otherwise pairs for the
    spatial axes, innermost first (``[left, right, top, bottom, ...]``),
    the spatial axes being those between N and C for a channel-last
    ``data_format`` and after N, C otherwise. ``constant`` (``value``),
    ``reflect``, ``replicate`` and ``circular`` modes, any rank."""
    x = to_tensor_arg(x)
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pad) // 2
        width = [(0, 0)] * nd
        if data_format.upper().endswith("C") and nd >= 3:
            spatial = list(range(1, nd - 1))[-k:]
        else:
            spatial = list(range(2, nd))[-k:]
        for ax, i in zip(reversed(spatial), range(k)):
            width[ax] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return F.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(x, ax, _pad_index(x.shape[ax], lo, hi,
                                                     mode, x.device))
    return x


def crop(x, shape=None, offsets=None, name=None):
    x = to_tensor_arg(x)
    shape = _ints(shape)
    offsets = [0] * x.ndim if offsets is None else _ints(offsets)
    shape = [xs if s == -1 else s for s, xs in zip(shape, x.shape)]
    return x[tuple(_slice(o, o + s) for o, s in zip(offsets, shape))]


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    inp = to_tensor_arg(input)
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(inp, size, rounding_mode="floor")
                       == shard_id, torch.remainder(inp, size),
                       torch.full_like(inp, ignore_value)).detach()


def as_real(x, name=None):
    x = to_tensor_arg(x)
    return torch.stack([x.real, x.imag], dim=-1)


def as_complex(x, name=None):
    x = to_tensor_arg(x)
    return torch.complex(x[..., 0], x[..., 1])


def numel(x, name=None):
    x = to_tensor_arg(x)
    return as_tensor(torch.tensor(x.numel(), dtype=torch.int64,
                                  device=x.device))


def shape(x):
    x = to_tensor_arg(x)
    return as_tensor(torch.tensor(list(x.shape), dtype=torch.int32,
                                  device=x.device))


def is_tensor(x):
    return isinstance(x, torch.Tensor)

