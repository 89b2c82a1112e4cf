"""The tail of Paddle's top-level tensor surface (counterpart of
``paddle_tpu/ops/extras.py``): ``add_n``, ``tensordot``,
``searchsorted``, the NaN-ignoring quantiles, ``renorm`` and the rest.
``nanmedian`` is ``jnp.nanmedian``'s: the mean of the two middle
non-NaN values (``torch.nanmedian`` takes the lower one)."""
from __future__ import annotations

import torch

from ..core.tensor import as_tensor, to_tensor_arg
from .manipulation import flip, shape, split

__all__ = ["add_n", "bucketize", "complex", "diagonal", "frexp", "mv",
           "nanmedian", "nanquantile", "renorm", "reverse", "searchsorted",
           "sgn", "take", "tanh_", "tensordot", "unstack", "vsplit",
           "rank", "shape", "tolist"]


def add_n(inputs, name=None):
    ts = [to_tensor_arg(x) for x in (inputs if isinstance(inputs,
                                                          (list, tuple))
                                     else [inputs])]
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def _side(x, out_int32):
    return x.to(torch.int32 if out_int32 else torch.int64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return _side(torch.searchsorted(to_tensor_arg(sorted_sequence),
                                    to_tensor_arg(x), right=right),
                 out_int32)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """Insertion points of ``values`` in each row of the sorted rows (a
    1-d sequence serves every value)."""
    return _side(torch.searchsorted(to_tensor_arg(sorted_sequence),
                                    to_tensor_arg(values), right=right),
                 out_int32)


def complex(real, imag, name=None):  # noqa: A001 - Paddle's name
    return torch.complex(to_tensor_arg(real), to_tensor_arg(imag))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(to_tensor_arg(x), offset, axis1, axis2)


def frexp(x, name=None):
    """(mantissa, exponent), the exponent in x's dtype."""
    x = to_tensor_arg(x)
    m, e = torch.frexp(x)
    return m, e.to(x.dtype)


def mv(x, vec, name=None):
    return to_tensor_arg(x) @ to_tensor_arg(vec)


def _nan_over(x, axis, keepdim, q):
    """``nanquantile`` of q over ``axis`` (None: all), as ``jnp``'s."""
    from .reduction import _over_last

    x = to_tensor_arg(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return _over_last(lambda m: torch.nanquantile(m, qt, dim=-1), x,
                      axis, keepdim, lead=qt.ndim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _nan_over(x, axis, keepdim, 0.5)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _nan_over(x, axis, keepdim, q)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` whose p-norm exceeds ``max_norm`` is
    scaled to ``max_norm / (norm + 1e-7)`` of itself."""
    x = to_tensor_arg(x)
    axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axes,
                                keepdim=True), 1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
    return x * scale


def reverse(x, axis, name=None):
    return flip(x, axis)


def sgn(x, name=None):
    """The sign of a real x; the unit phase of a complex one (0 at 0)."""
    return torch.sgn(to_tensor_arg(x))


def take(x, index, mode="raise", name=None):
    """Elements of flattened x at ``index``: ``raise`` checks the range
    (one host read), ``wrap`` takes it modulo the size, ``clip`` clips;
    a negative index counts from the end."""
    x, idx = to_tensor_arg(x), to_tensor_arg(index).long()
    n = x.numel()
    if mode == "raise" and bool(((idx < -n) | (idx >= n)).any()):
        raise IndexError("take: index out of range")
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return x.reshape(-1)[idx]


@torch.no_grad()
def tanh_(x, name=None):
    return x.tanh_()


def tensordot(x, y, axes=2, name=None):
    if not isinstance(axes, int):
        a, b = axes
        axes = ([a] if isinstance(a, int) else list(a),
                [b] if isinstance(b, int) else list(b))
    return torch.tensordot(to_tensor_arg(x), to_tensor_arg(y), dims=axes)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(to_tensor_arg(x), axis))


def vsplit(x, num_or_sections, name=None):
    x = to_tensor_arg(x)
    if x.ndim < 2:
        raise ValueError("vsplit expects ndim >= 2")
    return split(x, num_or_sections, axis=0)


def rank(input, name=None):  # noqa: A002
    x = to_tensor_arg(input)
    return as_tensor(torch.tensor(x.ndim, dtype=torch.int32,
                                  device=x.device))


def tolist(x):
    return to_tensor_arg(x).tolist()

