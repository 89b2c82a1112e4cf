"""String tensors (counterpart of ``paddle_tpu/strings.py``).

String data has no device representation (Paddle's ``pstring`` kernels
are host kernels too), so a ``StringTensor`` wraps a numpy object array;
Python's ``str.lower`` / ``str.upper`` are the unicode case mapping.
"""
from __future__ import annotations

import numpy as np

__all__ = ["StringTensor", "to_string_tensor", "empty", "empty_like",
           "lower", "upper", "copy"]


class StringTensor:
    """Host tensor of strings (reference ``phi::StringTensor``)."""

    def __init__(self, data, name=None):
        arr = np.asarray(data, dtype=object)
        self._data = arr
        self.name = name

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return "pstring"

    def numpy(self):
        return self._data

    def tolist(self):
        return self._data.tolist()

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, {self._data!r})"

    def __eq__(self, other):
        other = other._data if isinstance(other, StringTensor) else other
        return bool(np.array_equal(self._data, np.asarray(other, object)))


def to_string_tensor(data, name=None):
    return StringTensor(data, name=name)


def empty(shape, name=None):
    """Reference ``strings_empty_kernel``: uninitialized -> empty strings."""
    arr = np.empty(tuple(shape), object)
    arr.fill("")
    return StringTensor(arr)


def empty_like(x, name=None):
    return empty(x.shape)


def _map(x, fn):
    out = np.empty(x._data.shape, object)
    it = np.nditer(x._data, flags=["multi_index", "refs_ok"])
    for _ in it:
        idx = it.multi_index
        out[idx] = fn(x._data[idx])
    return StringTensor(out)


def lower(x, use_utf8_encoding=True, name=None):
    """Reference ``StringsLowerKernel``: ascii-only when
    ``use_utf8_encoding`` is False, full unicode otherwise."""
    if use_utf8_encoding:
        return _map(x, str.lower)
    return _map(x, lambda s: "".join(
        c.lower() if c.isascii() else c for c in s))


def upper(x, use_utf8_encoding=True, name=None):
    if use_utf8_encoding:
        return _map(x, str.upper)
    return _map(x, lambda s: "".join(
        c.upper() if c.isascii() else c for c in s))


def copy(x, name=None):
    """Reference ``strings_copy_kernel``."""
    return StringTensor(x._data.copy())
