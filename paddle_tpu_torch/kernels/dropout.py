"""Dropout with the JAX package's threefry masks: a hand-written CUDA
kernel and its plain version.

The JAX package's dropout (``paddle_tpu/ops/nn_ops.py:273``) keeps an
element where ``jax.random.bernoulli(key, 1 - p, mask_shape)`` is True
and writes ``x / (1 - p)`` there (``upscale_in_train``; ``x`` for
``downscale_in_infer``), 0 elsewhere; a ``mask_shape`` with size-1 axes
broadcasts one draw over them (``dropout2d`` / ``3d``, ``axis``). It has
no Pallas kernel (XLA fuses the draw and the select); the port's is
``csrc/dropout.cu``, built at first use:

- :func:`dropout_cuda`: the kernel (float32, bfloat16, float16; CUDA
  tensors only), one pass that hashes each element's counter;
- :func:`dropout_ref`: the plain version on ``core/threefry.py``'s
  ``bernoulli`` (int64 tensors, some hundred passes): what the CPU runs
  and what the kernel is held against on the card.

The kept values are divided by ``1 - p`` rounded to x's dtype, the
quotient formed in float32 and rounded once, as the JAX package's
``x / (1.0 - p)`` is; never multiplied by a reciprocal.
:func:`dropout` is the differentiable entry: a ``torch.autograd.Function``
that keeps only the key and regenerates the mask in the backward (``dx
= dropout(dy)`` under the same key: the same function). CUDA tensors
take the kernel and CPU tensors the plain version, never one for the
other.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from ..core import threefry
from ..core.dispatch import recordable

__all__ = ["KERNEL_NAME", "LAUNCHES", "dropout", "dropout_ref",
           "dropout_cuda", "mask_geometry"]

KERNEL_NAME = "dropout"
# kernel launches: the wrapper adds one where it launches the kernel and
# nowhere else (reset with LAUNCHES.clear())
LAUNCHES: "collections.Counter[str]" = collections.Counter()
_LIB = "dropout"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_MAX_DIMS = 8


def mask_geometry(shape: Sequence[int], mask_shape: Optional[Sequence[int]]
                  ) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """``None`` when the mask covers x element for element, else
    ``(dims, strides)``: x's shape and the mask's row-major strides with
    0 on the axes it broadcasts over."""
    shape = tuple(int(s) for s in shape)
    if mask_shape is None or tuple(mask_shape) == shape:
        return None
    mask_shape = tuple(int(s) for s in mask_shape)
    if len(mask_shape) != len(shape) or any(
            m not in (1, s) for m, s in zip(mask_shape, shape)):
        raise ValueError(f"mask shape {mask_shape} does not broadcast to "
                         f"{shape}")
    strides, acc = [], 1
    for m in reversed(mask_shape):
        strides.append(acc if m > 1 else 0)
        acc *= m
    return shape, tuple(reversed(strides))


def _divisor(p: float, dtype: torch.dtype) -> torch.Tensor:
    """``1 - p`` rounded to ``dtype`` (a Python float's weak type in JAX
    takes x's dtype), as a float32 scalar."""
    return torch.tensor(1.0 - p, dtype=dtype).float()


def dropout_ref(x: torch.Tensor, key, p: float,
                mask_shape: Optional[Sequence[int]] = None,
                upscale: bool = True, start: int = 0) -> torch.Tensor:
    """The plain version: ``where(bernoulli(key, 1 - p, mask_shape), x /
    (1 - p) or x, 0)`` in x's dtype. With ``start`` (and no broadcast
    mask), ``x`` is the flat slice of a larger tensor that begins at
    flat index ``start``: the mask is drawn for those indices alone."""
    key = threefry.as_key(key, x.device)
    if mask_shape is not None and tuple(mask_shape) != tuple(x.shape):
        if start:
            raise ValueError("a flat slice takes no broadcast mask")
        keep = threefry.bernoulli(key, 1.0 - p, tuple(mask_shape))
    elif start:
        keep = threefry.bernoulli(key, 1.0 - p, start + x.numel(), start,
                                  x.numel()).reshape(x.shape)
    else:
        keep = threefry.bernoulli(key, 1.0 - p, tuple(x.shape))
    if upscale:
        xf = x.float()
        # a tensor divisor: a Python scalar would be applied as a
        # multiply by its reciprocal on the card
        val = (xf / torch.full_like(
            xf, _divisor(p, x.dtype).item())).to(x.dtype)
    else:
        val = x
    return torch.where(keep, val, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def _entry(dtype: torch.dtype):
    from ._build import load

    fn = getattr(load(_LIB), f"dropout_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dropout_cuda(x: torch.Tensor, key, p: float,
                 mask_shape: Optional[Sequence[int]] = None,
                 upscale: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream: the output, shaped and
    typed as x. ``x`` must be a contiguous CUDA tensor of float32,
    bfloat16 or float16 (anything else raises); ``0 < p < 1``."""
    if not x.is_cuda:
        raise ValueError(f"the dropout kernel needs a CUDA tensor; x is on "
                         f"{x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"the dropout kernel takes {list(_SUFFIX)}, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the dropout kernel needs a contiguous tensor")
    if not 0.0 < p < 1.0:
        raise ValueError(f"the dropout kernel takes 0 < p < 1, got {p}")
    geom = mask_geometry(x.shape, mask_shape)
    if geom is not None and len(geom[0]) > _MAX_DIMS:
        raise ValueError(f"the dropout kernel takes at most {_MAX_DIMS} "
                         "dims with a broadcast mask")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    k0, k1 = threefry.key_words(key)
    ndim, dims, strides = 0, None, None
    if geom is not None:
        ndim = len(geom[0])
        dims = (ctypes.c_longlong * ndim)(*geom[0])
        strides = (ctypes.c_longlong * ndim)(*geom[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(x.dtype)(x.data_ptr(), y.data_ptr(), x.numel(), k0, k1,
                          1.0 - p, _divisor(p, x.dtype).item(),
                          int(bool(upscale)), ndim, dims, strides, stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL_NAME] += 1
    return y


def _apply(x, key, p, mask_shape, upscale):
    if x.is_cuda:
        return dropout_cuda(x.contiguous(), key, p, mask_shape, upscale)
    return dropout_ref(x, key, p, mask_shape, upscale)


class _Dropout(torch.autograd.Function):
    """Forward and backward are the same function under the same key (the
    JAX vjp of ``where(keep, x / c, 0)`` is ``where(keep, dy, 0) / c``);
    only the key is kept."""

    @staticmethod
    def forward(ctx, x, key, p, mask_shape, upscale):
        ctx.args = (key, p, mask_shape, upscale)
        return _apply(x, key, p, mask_shape, upscale)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy, *ctx.args), None, None, None, None


@recordable("dropout", lambda x, *args, **kwargs: torch.empty_like(x))
def dropout(x: torch.Tensor, key, p: float,
            mask_shape: Optional[Sequence[int]] = None,
            upscale: bool = True) -> torch.Tensor:
    """Differentiable dropout of ``x`` under ``key`` (a ``[2]`` key,
    see ``core/threefry.py``) with ``0 < p < 1``. A static program
    records it as the one op ``dropout`` (its key drawn at recording,
    as the JAX package's recorded dropout bakes its key)."""
    key = threefry.as_key(key)
    if mask_shape is not None and math.prod(mask_shape) == x.numel():
        mask_shape = None
    return _Dropout.apply(x, key, float(p),
                          None if mask_shape is None else tuple(mask_shape),
                          bool(upscale))
