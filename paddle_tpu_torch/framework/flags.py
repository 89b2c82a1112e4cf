"""Global flag registry: ``paddle.set_flags`` / ``paddle.get_flags``.

Counterpart of ``paddle_tpu/framework/flags.py``: the same names and
defaults, read from ``FLAGS_*`` environment variables at import. Two
flags act: ``FLAGS_check_nan_inf`` makes every op on a port ``Tensor``
(the ``Tensor`` hook and the op registry, the port's dispatchers) check
its floating outputs for NaN and infinity, and
``FLAGS_cudnn_deterministic`` sets ``torch.backends.cudnn.deterministic``.
The allocator and cuDNN-search flags are accepted and inert, as in the
JAX package.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Union

import torch

from ..core import tensor as _tensor

__all__ = ["set_flags", "get_flags"]

_lock = threading.Lock()
_flags: Dict[str, Any] = {}
_known_inert = {
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_use_system_allocator": False,
    "FLAGS_cudnn_exhaustive_search": False,
    "FLAGS_conv_workspace_size_limit": 512,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_use_stream_safe_cuda_allocator": True,
}


def _init():
    _flags.update(_known_inert)
    _flags["FLAGS_check_nan_inf"] = False
    _flags["FLAGS_cudnn_deterministic"] = False
    _flags["FLAGS_eager_dispatch_warning"] = True
    for k, v in os.environ.items():
        if k.startswith("FLAGS_"):
            _flags[k] = _parse(v)
            _apply_live(k, _flags[k])


def _parse(v: str):
    low = v.lower()
    if low in ("true", "1"):
        return True
    if low in ("false", "0"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _apply_live(name: str, value):
    if name == "FLAGS_check_nan_inf":
        _tensor.CHECK_NAN_INF[0] = bool(value)
    elif name == "FLAGS_cudnn_deterministic":
        torch.backends.cudnn.deterministic = bool(value)


def set_flags(flags: Dict[str, Any]):
    """``paddle.set_flags({'FLAGS_check_nan_inf': True})``."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict")
    with _lock:
        for k, v in flags.items():
            if not k.startswith("FLAGS_"):
                raise ValueError(f"flag names start with FLAGS_: {k!r}")
            _flags[k] = v
            _apply_live(k, v)


def get_flags(flags: Union[str, List[str], None] = None) -> Dict[str, Any]:
    with _lock:
        if flags is None:
            return dict(_flags)
        if isinstance(flags, str):
            flags = [flags]
        out = {}
        for k in flags:
            if k not in _flags:
                raise ValueError(f"unknown flag {k!r}")
            out[k] = _flags[k]
        return out


_init()
