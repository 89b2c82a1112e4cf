"""Symmetric absmax int8 quantization and the int8 x int8 matmul.

Counterpart of ``paddle_tpu/kernels/int8.py``'s ``quantize_absmax`` and
``dequantize`` (the glue the weight-only int8 serving path and the int8
KV pages share): float32 arithmetic, round half to even, codes clipped
to +-127, scales floored at 1e-8 so an all-zero row quantizes to zeros
rather than NaN. Bit for bit the JAX package's codes and scales.

The int8 weight matmul of quantized serving (``weight_matmul="int8"``,
the JAX ``model._int8_dot``) runs on two hand-written kernels of
``csrc/int8_matmul.cu``, each with its plain PyTorch version beside it:

- :func:`quantize_rows`: ``x [M, K]`` float32 -> ``(xq int8 [M, K],
  xs float32 [M, 1])``, the per-row absmax quantizer;
- :func:`int8_matmul`: ``(xq, xs, wqt, ws) -> float32 [M, N]``, int8 x
  int8 with int32 sums, then ``acc.float() * xs * ws`` in that order.
  The weight codes come TRANSPOSED, ``wqt [N, K]`` (K contiguous: the
  layout the tensor cores' B operand loads), beside their
  per-output-channel scales ``ws`` (N of them).

Both launch their kernel for CUDA tensors and take the plain version
for CPU tensors, and nothing else; each launch adds one to
``paged_attention.LAUNCHES`` under its name, which the engine's CUDA
graphs replay-count like the attention kernels'. The plain
``int8_matmul`` multiplies the codes in float64 (integer matmuls have
no CUDA kernel): every sum is an integer below 2^53, so it is exact,
and the kernel equals it bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .paged_attention import LAUNCHES

__all__ = ["quantize_absmax", "dequantize", "quantize_rows",
           "quantize_rows_ref", "quantize_rows_cuda", "int8_matmul",
           "int8_matmul_ref", "int8_matmul_cuda", "QUANTIZE_ROWS_KERNEL",
           "INT8_MATMUL_KERNEL"]

# LAUNCHES keys of the two kernels
QUANTIZE_ROWS_KERNEL = "quantize_rows"
INT8_MATMUL_KERNEL = "int8_matmul"
_LIB = "int8_matmul"

INT8_QMAX = 127.0
SCALE_EPS = 1e-8


def quantize_absmax(x: torch.Tensor, axis: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q int8, scale float32)``. ``axis`` picks per-channel
    scales, kept as a size-1 axis so dequantization is a broadcast
    multiply; ``None`` takes one scale for the whole tensor (0-d). The
    scale is a true division ``amax / 127`` (by a tensor: PyTorch
    applies a Python-scalar divisor of a CUDA tensor as a multiply by
    its reciprocal, an ulp away from JAX's division)."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, INT8_QMAX),
                        min=SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q x scale`` in float32 (``scale`` broadcasts), cast to
    ``dtype``."""
    return (q.to(torch.float32) * scale).to(dtype)


# ------------------------------------------- the int8 weight matmul --

def quantize_rows_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the row quantizer: ``x [M, K]`` -> ``(xq int8
    [M, K], xs float32 [M, 1])``, :func:`quantize_absmax` over the last
    axis with every division a true one: PyTorch divides a CUDA tensor
    by a Python scalar as a multiply by its reciprocal, which can land
    an ulp away from JAX's (and the kernel's) ``amax / 127``, so the
    divisor here is a tensor."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, INT8_QMAX),
                        min=SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def int8_matmul_ref(xq: torch.Tensor, xs: torch.Tensor, wqt: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 matmul: ``xq [M, K]`` int8 times
    ``wqt [N, K]`` int8 (transposed weight codes), summed exactly (in
    float64: integers below 2^53), converted to float32 as an int32 sum
    would be, then ``* xs [M, 1] * ws`` (N scales) in that order."""
    acc = xq.to(torch.float64) @ wqt.to(torch.float64).t()
    return (acc.to(torch.float32) * xs.reshape(-1, 1)
            * ws.reshape(1, -1).to(torch.float32))


def _fn(entry: str, argtypes):
    from ._build import load

    fn = getattr(load(_LIB), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"the {kernel} kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def quantize_rows_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the row quantizer on the current stream (``x`` float32
    ``[M, K]`` on the card)."""
    _check_cuda("quantize_rows", x=x)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    fn = _fn("quantize_rows_f32", [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), M, K,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[QUANTIZE_ROWS_KERNEL] += 1
    return xq, xs


def int8_matmul_cuda(xq: torch.Tensor, xs: torch.Tensor, wqt: torch.Tensor,
                     ws: torch.Tensor) -> torch.Tensor:
    """Launch the int8 matmul on the current stream: ``xq [M, K]`` and
    ``wqt [N, K]`` int8, ``xs`` (M) and ``ws`` (N) float32, K a
    multiple of 16 and both code tensors 16-byte aligned."""
    _check_cuda("int8_matmul", xq=xq, xs=xs, wqt=wqt, ws=ws)
    if xq.dim() != 2 or wqt.dim() != 2 or xq.shape[1] != wqt.shape[1]:
        raise ValueError(f"xq [M, K] and wqt [N, K] disagree: "
                         f"{tuple(xq.shape)} / {tuple(wqt.shape)}")
    M, K = xq.shape
    N = wqt.shape[0]
    if xq.dtype != torch.int8 or wqt.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {xq.dtype}/{wqt.dtype}")
    if (xs.dtype != torch.float32 or ws.dtype != torch.float32
            or xs.numel() != M or ws.numel() != N):
        raise ValueError(f"scales must be float32 with {M} and {N} "
                         f"entries, got {xs.dtype} {tuple(xs.shape)} / "
                         f"{ws.dtype} {tuple(ws.shape)}")
    if K % 16 or xq.data_ptr() % 16 or wqt.data_ptr() % 16:
        raise ValueError("the int8 matmul takes K a multiple of 16 and "
                         f"16-byte aligned codes; got K={K}")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    fn = _fn("int8_matmul_s8", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
    err = fn(xq.data_ptr(), xs.data_ptr(), wqt.data_ptr(), ws.data_ptr(),
             out.data_ptr(), M, N, K,
             torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[INT8_MATMUL_KERNEL] += 1
    return out


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row quantizer: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return quantize_rows_cuda(x)
    return quantize_rows_ref(x)


def int8_matmul(xq: torch.Tensor, xs: torch.Tensor, wqt: torch.Tensor,
                ws: torch.Tensor) -> torch.Tensor:
    """The int8 x int8 matmul with its epilogue rescale: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if xq.is_cuda:
        return int8_matmul_cuda(xq, xs, wqt, ws)
    return int8_matmul_ref(xq, xs, wqt, ws)
