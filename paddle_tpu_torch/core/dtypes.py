"""Paddle's dtype names over torch dtypes.

Counterpart of ``paddle_tpu/core/dtypes.py``: the same names and
aliases (``"float32"``, ``"float"``, ``"long"`` ...) map to ``torch``
dtypes, and the default floating dtype (float32) is what Python floats
become in :func:`~paddle_tpu_torch.to_tensor` and what layers create
their parameters in.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating_point", "is_complex",
           "is_integer", "get_default_dtype", "set_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAMES = {"bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
          "int32": int32, "int64": int64, "float16": float16,
          "bfloat16": bfloat16, "float32": float32, "float64": float64,
          "complex64": complex64, "complex128": complex128}
_ALIASES = {**_NAMES, "float": float32, "double": float64, "half": float16,
            "int": int32, "long": int64}
_BY_DTYPE = {v: k for k, v in _NAMES.items()}

FLOAT_DTYPES = (float16, bfloat16, float32, float64)
COMPLEX_DTYPES = (complex64, complex128)
INT_DTYPES = (uint8, int8, int16, int32, int64)


def convert_dtype(dtype):
    """A torch dtype for any dtype spec: a Paddle name or alias, a torch
    dtype, a numpy dtype or scalar type; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _ALIASES:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _ALIASES[dtype]
    name = np.dtype(dtype).name
    if name not in _NAMES:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _NAMES[name]


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype (``torch.float32`` -> ``"float32"``)."""
    return _BY_DTYPE[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOAT_DTYPES


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in COMPLEX_DTYPES


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in INT_DTYPES or d == bool_


_DEFAULT_DTYPE = [float32]


def get_default_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE[0]


def set_default_dtype(dtype) -> None:
    d = convert_dtype(dtype)
    if not is_floating_point(d):
        raise TypeError(f"default dtype must be floating point, got {d}")
    _DEFAULT_DTYPE[0] = d
