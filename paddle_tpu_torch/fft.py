"""``paddle.fft``: discrete Fourier transforms over ``torch.fft``
(counterpart of ``paddle_tpu/fft.py``, which calls ``jnp.fft``).

The transforms are cuFFT's on the card and pocketfft's on the host, as
XLA's FFT is the JAX package's: a library transform, differentiable
through torch's autograd. ``hfftn`` / ``ihfftn`` keep the JAX package's
composition (the complex transform over the leading axes, ``hfft`` /
``ihfft`` over the last).
"""
from __future__ import annotations

import torch

from .core import dtypes as _dt
from .core.device import to_torch_device
from .core.tensor import as_tensor, to_tensor_arg

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = ("backward", "ortho", "forward")


def _check_norm(norm):
    if norm is None:
        return "backward"
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    return norm


def _one(fn):
    def transform(x, n=None, axis=-1, norm=None, name=None):
        return fn(to_tensor_arg(x), n=n, dim=axis, norm=_check_norm(norm))

    transform.__name__ = fn.__name__
    transform.__doc__ = f"``torch.fft.{fn.__name__}`` with Paddle's " \
                        "arguments (``axis``)."
    return transform


fft = _one(torch.fft.fft)
ifft = _one(torch.fft.ifft)
rfft = _one(torch.fft.rfft)
irfft = _one(torch.fft.irfft)
hfft = _one(torch.fft.hfft)
ihfft = _one(torch.fft.ihfft)


def _tuple(v):
    return tuple(v) if v else None


def _many(fn):
    def transform(x, s=None, axes=None, norm=None, name=None):
        return fn(to_tensor_arg(x), s=_tuple(s), dim=_tuple(axes),
                  norm=_check_norm(norm))

    transform.__name__ = fn.__name__
    transform.__doc__ = f"``torch.fft.{fn.__name__}`` with Paddle's " \
                        "arguments (``axes``; none or empty: every axis)."
    return transform


fftn = _many(torch.fft.fftn)
ifftn = _many(torch.fft.ifftn)
rfftn = _many(torch.fft.rfftn)
irfftn = _many(torch.fft.irfftn)


def _axes_of(a, s, axes):
    axes = _tuple(axes) or tuple(range(-a.ndim, 0))
    return axes, (lambda i: s[i] if s else None)


def hfftn(x, s=None, axes=None, norm=None, name=None):
    """``fft`` over every axis but the last, then ``hfft`` over it."""
    a, norm = to_tensor_arg(x), _check_norm(norm)
    axes, size = _axes_of(a, s, axes)
    for i, ax in enumerate(axes[:-1]):
        a = torch.fft.fft(a, n=size(i), dim=ax, norm=norm)
    return torch.fft.hfft(a, n=size(len(axes) - 1), dim=axes[-1], norm=norm)


def ihfftn(x, s=None, axes=None, norm=None, name=None):
    """``ihfft`` over the last axis, then ``ifft`` over the others."""
    a, norm = to_tensor_arg(x), _check_norm(norm)
    axes, size = _axes_of(a, s, axes)
    a = torch.fft.ihfft(a, n=size(len(axes) - 1), dim=axes[-1], norm=norm)
    for i, ax in enumerate(axes[:-1]):
        a = torch.fft.ifft(a, n=size(i), dim=ax, norm=norm)
    return a


def fft2(x, s=None, axes=(-2, -1), norm=None, name=None):
    return fftn(x, s, _pair(axes), norm)


def ifft2(x, s=None, axes=(-2, -1), norm=None, name=None):
    return ifftn(x, s, _pair(axes), norm)


def rfft2(x, s=None, axes=(-2, -1), norm=None, name=None):
    return rfftn(x, s, _pair(axes), norm)


def irfft2(x, s=None, axes=(-2, -1), norm=None, name=None):
    return irfftn(x, s, _pair(axes), norm)


def hfft2(x, s=None, axes=(-2, -1), norm=None, name=None):
    return hfftn(x, s, _pair(axes), norm)


def ihfft2(x, s=None, axes=(-2, -1), norm=None, name=None):
    return ihfftn(x, s, _pair(axes), norm)


def _pair(axes):
    return tuple(axes) if axes is not None else (-2, -1)


def _freq(fn, n, d, dtype):
    return as_tensor(fn(int(n), float(d),
                        dtype=_dt.convert_dtype(dtype)
                        or _dt.get_default_dtype(),
                        device=to_torch_device(None)))


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def _shift_axes(axes):
    return tuple(axes) if isinstance(axes, (list, tuple)) else axes


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(to_tensor_arg(x), dim=_shift_axes(axes))


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(to_tensor_arg(x), dim=_shift_axes(axes))
