"""Sequence ops over padded batches (counterpart of
``paddle_tpu/static/sequence.py``; reference
``paddle/fluid/operators/sequence_ops/`` and
``python/paddle/static/nn/sequence_lod.py``).

A ragged batch is dense ``[B, T, ...]`` data plus a ``length [B]``
tensor, as in the JAX package (the reference's LoD tensors are not
ported). Ops that read sequences take ``(x, length)``; ops that make
sequences return the pair (or x alone when the lengths pass through).

The ops whose output shape follows from their inputs' shapes run
eagerly and, given static ``Variable``s, are recorded as one op each
under their JAX name (``core.dispatch.recordable``: the function itself
shapes the output on fake tensors). ``sequence_expand``, ``sequence_pad``,
``sequence_unpad`` and ``sequence_slice`` read lengths on the host to
size their outputs, so they run eagerly only, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import recordable
from ..core.tensor import to_numpy, to_tensor, to_tensor_arg

__all__ = [
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]


def _op(name: str):
    """Record the decorated function as the one op ``name`` on static
    inputs, shaped by running itself on fake tensors."""
    def deco(fn):
        return recordable(name, fn)(fn)
    return deco


def _mask(length, T: int):
    return (torch.arange(T, device=length.device)[None, :]
            < length[:, None])


def _trailing(t, x):
    """``t`` ``[B, T]`` reshaped to broadcast over x's trailing axes."""
    return t.reshape(*t.shape, *([1] * (x.ndim - 2)))


def _np(x) -> np.ndarray:
    x = to_tensor_arg(x)
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _place(x):
    return x.device if isinstance(x, torch.Tensor) else None


@_op("sequence_softmax")
def _softmax(x, length):
    m = _mask(length, x.shape[1])
    logits = torch.where(m, x.float(), torch.full_like(x, -1e30,
                                                       dtype=torch.float32))
    p = torch.softmax(logits, dim=1)
    return torch.where(m, p, torch.zeros_like(p)).to(x.dtype)


def sequence_softmax(x, length=None, name=None):
    """Softmax over the valid prefix of each row (reference
    ``sequence_softmax_op``); padded positions get probability 0."""
    x = to_tensor_arg(x)
    if length is None:
        return torch.softmax(x, dim=-1)
    return _softmax(x, to_tensor_arg(length))


@_op("sequence_pool")
def _pool(x, length, pool_type):
    T = x.shape[1]
    m = _trailing(_mask(length, T), x)
    xf = x.float()
    lf = _trailing(length.float().clamp(min=1.0)[:, None], x)[:, 0]
    if pool_type == "sum":
        out = torch.sum(xf * m, dim=1)
    elif pool_type == "average":
        out = torch.sum(xf * m, dim=1) / lf
    elif pool_type == "sqrt":
        out = torch.sum(xf * m, dim=1) / torch.sqrt(lf)
    elif pool_type == "max":
        out = torch.amax(torch.where(m, xf, torch.full_like(xf, -np.inf)),
                         dim=1)
    elif pool_type == "min":
        out = torch.amin(torch.where(m, xf, torch.full_like(xf, np.inf)),
                         dim=1)
    elif pool_type == "first":
        out = xf[:, 0]
    elif pool_type == "last":
        idx = torch.clamp(length - 1, min=0).long()
        idx = _trailing(idx[:, None], x).expand(-1, 1, *x.shape[2:])
        out = torch.gather(xf, 1, idx)[:, 0]
    else:
        raise ValueError(pool_type)
    return out.to(x.dtype)


def sequence_pool(x, pool_type="sum", length=None, pad_value=0.0, name=None):
    """Masked reduction over time (reference ``sequence_pool_op``):
    sum / average / sqrt / max / min / first / last."""
    x = to_tensor_arg(x)
    if length is None:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
    return _pool(x, to_tensor_arg(length), pool_type=pool_type.lower())


def sequence_first_step(x, length=None, name=None):
    return sequence_pool(x, "first", length)


def sequence_last_step(x, length=None, name=None):
    return sequence_pool(x, "last", length)


@_op("sequence_reverse")
def _reverse(x, length):
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    l = length[:, None].long()
    src = torch.where(pos < l, l - 1 - pos, pos)
    return torch.gather(x, 1, _trailing(src, x).expand_as(x))


def sequence_reverse(x, length=None, name=None):
    """Reverse each valid prefix in place (reference
    ``sequence_reverse_op``); padding stays at the tail."""
    x = to_tensor_arg(x)
    if length is None:
        return torch.flip(x, dims=[1])
    return _reverse(x, to_tensor_arg(length))


@_op("sequence_concat")
def _concat(*args):
    n = len(args) // 2
    xs, ls = args[:n], args[n:]
    B = xs[0].shape[0]
    T_out = sum(x.shape[1] for x in xs)
    feat = tuple(xs[0].shape[2:])
    # one overflow slot past the end takes the padded positions
    out = torch.zeros((B, T_out + 1) + feat, dtype=xs[0].dtype,
                      device=xs[0].device)
    offs = torch.zeros((B,), dtype=torch.int64, device=xs[0].device)
    for x, l in zip(xs, ls):
        T = x.shape[1]
        pos = torch.arange(T, device=x.device)[None, :]
        valid = pos < l[:, None]
        dst = torch.where(valid, offs[:, None] + pos,
                          torch.full_like(pos, T_out))
        out = out.scatter(1, _trailing(dst, x).expand_as(x), x)
        offs = offs + l.long()
    return out[:, :T_out], sum(ls).long()


def sequence_concat(inputs, lengths=None, name=None):
    """Per-sample concat of the valid prefixes (reference
    ``sequence_concat_op``); returns ``(out, out_length)``, the tail
    past each row's total length zero."""
    xs = [to_tensor_arg(i) for i in inputs]
    if lengths is None:
        return torch.cat(xs, dim=1)
    return _concat(*xs, *(to_tensor_arg(l) for l in lengths))


def sequence_expand(x, ref_length, name=None):
    """Repeat each sample by the reference sequence's length (dense form
    of ``sequence_expand_op``): x ``[B, ...]`` -> ``[sum(ref_length),
    ...]`` ordered by sample. A host op: the output size is data."""
    out = np.repeat(_np(x), _np(ref_length).astype(np.int64), axis=0)
    return to_tensor(out, place=_place(x))


@_op("sequence_expand_as")
def _expand_as(x, n):
    return torch.repeat_interleave(x, n, dim=0)


def sequence_expand_as(x, y, name=None):
    """Each row of x repeated ``len(y) / len(x)`` times (reference
    ``sequence_expand_as_op``)."""
    x, y = to_tensor_arg(x), to_tensor_arg(y)
    return _expand_as(x, n=y.shape[0] // x.shape[0])


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """Pack flat rows into ``[B, maxlen, ...]`` (reference
    ``sequence_pad_op``): x's rows are the samples' steps one after the
    other, ``length [B]`` counts each sample's. Returns ``(padded,
    length)``. A host op."""
    x_np = _np(x)
    l_np = _np(length).astype(np.int64)
    pv = (float(pad_value) if isinstance(pad_value, (int, float))
          else float(_np(pad_value).reshape(-1)[0]))
    T = int(maxlen) if maxlen is not None else int(l_np.max())
    out = np.full((len(l_np), T) + x_np.shape[1:], pv, x_np.dtype)
    off = 0
    for i, n in enumerate(l_np):
        out[i, :n] = x_np[off:off + n]
        off += n
    return to_tensor(out, place=_place(x)), to_tensor(l_np, place=_place(x))


def sequence_unpad(x, length, name=None):
    """The inverse of ``sequence_pad``: the valid steps as flat rows."""
    x_np = _np(x)
    rows = [x_np[i, :n] for i, n in enumerate(_np(length).astype(np.int64))]
    return to_tensor(np.concatenate(rows, axis=0), place=_place(x))


@_op("sequence_reshape")
def _reshape(x, new_dim):
    return x.reshape(-1, new_dim)


def sequence_reshape(x, new_dim, name=None):
    """Reference ``sequence_reshape_op``: flat rows reflowed to a new
    feature width."""
    return _reshape(to_tensor_arg(x), new_dim=new_dim)


def _slice(x, off, l, T_out):
    pos = torch.arange(T_out, device=x.device)[None, :]
    src = torch.clamp(off.reshape(-1, 1).long() + pos, 0, x.shape[1] - 1)
    idx = src.reshape(x.shape[0], T_out, *([1] * (x.ndim - 2))).expand(
        -1, -1, *x.shape[2:])
    out = torch.gather(x, 1, idx)
    valid = _trailing(pos < l.reshape(-1, 1), x)
    return torch.where(valid, out, torch.zeros_like(out))


def sequence_slice(x, offset, length, name=None):
    """Per-sample slice of the time axis (reference
    ``sequence_slice_op``): ``out[i] = x[i, offset[i]:offset[i] +
    length[i]]``, padded to ``max(length)`` with zeros. Returns ``(out,
    length)``; the longest length is read on the host."""
    x, offset, length = (to_tensor_arg(a) for a in (x, offset, length))
    return _slice(x, offset, length, int(_np(length).max())), length


@_op("sequence_scatter")
def _scatter(x, index, updates):
    return x.index_add(0, index.long(), updates.to(x.dtype))


def sequence_scatter(x, index, updates, name=None):
    """Add ``updates [M, D]`` into the rows ``index [M]`` of ``x [N, D]``
    (reference ``sequence_scatter_op``)."""
    return _scatter(to_tensor_arg(x), to_tensor_arg(index),
                    to_tensor_arg(updates))


@_op("sequence_enumerate")
def _enumerate(x, win_size, pad_value):
    T = x.shape[1]
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(win_size, device=x.device)[None, :])
    g = x[:, torch.clamp(idx, max=T - 1)]
    return torch.where((idx < T)[None], g, torch.full_like(g, pad_value))


def sequence_enumerate(x, win_size, pad_value=0, name=None):
    """Sliding windows over each row (reference
    ``sequence_enumerate_op``): ``[B, T]`` ids -> ``[B, T, win_size]``,
    ``pad_value`` past the end."""
    return _enumerate(to_tensor_arg(x), win_size=win_size,
                      pad_value=pad_value)


@_op("sequence_conv")
def _conv(x, w, length, filter_size, start):
    B, T, D = x.shape
    cols = []
    for k in range(filter_size):
        idx = torch.arange(T, device=x.device) + (start + k)
        valid = ((idx >= 0) & (idx < T))[None, :]
        g = x[:, torch.clamp(idx, 0, T - 1)]
        if length is not None:
            valid = valid & (idx[None, :] < length[:, None])
        else:
            valid = valid.expand(B, T)
        cols.append(torch.where(valid[..., None], g, torch.zeros_like(g)))
    out = torch.cat(cols, dim=-1) @ w             # [B, T, k * D] @ [k * D, F]
    if length is not None:
        out = out * _mask(length, T).to(out.dtype)[..., None]
    return out.to(x.dtype)


def sequence_conv(input, num_filters=None, filter_size=3, filter_stride=1,  # noqa: A002
                  padding=True, padding_start=None, weight=None, bias=None,
                  length=None, act=None, name=None):
    """Context-window convolution over time (reference
    ``sequence_conv_op``): each step's ``filter_size`` rows of context,
    zeros outside the row and past its length, flattened into a
    ``[filter_size * D, num_filters]`` weight; then ``bias`` and ``act``
    (``relu`` or ``tanh``)."""
    if weight is None:
        raise ValueError("sequence_conv needs `weight` "
                         "[filter_size*D, num_filters]")
    start = (-((filter_size - 1) // 2) if padding_start is None
             else padding_start)
    out = _conv(to_tensor_arg(input), to_tensor_arg(weight),
                None if length is None else to_tensor_arg(length),
                filter_size=filter_size, start=start)
    if bias is not None:
        out = out + to_tensor_arg(bias)
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    return out
