"""``paddle.save`` / ``paddle.load``: the JAX package's pickle format.

Counterpart of ``paddle_tpu/framework/io.py``: a pickle of the nested
containers with each tensor as ``{"__tensor__": True, "data": <numpy
array>, "stop_gradient": ..., "name": ...}``, so a file written by
either package loads in the other. numpy has no bfloat16 of its own: a
bfloat16 tensor is written as its float32 values (exact) with ``"dtype":
"bfloat16"`` beside them, which the port reads back as bfloat16 and the
JAX package (which ignores the key) as float32. The JAX package writes
bfloat16 as ``ml_dtypes`` arrays, which unpickle only where
``ml_dtypes`` is installed; the port then reads them bit for bit.
"""
from __future__ import annotations

import os
import pickle

import torch

from ..core.tensor import to_numpy, to_tensor

__all__ = ["save", "load"]


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        out = {"__tensor__": True, "data": to_numpy(obj),
               "stop_gradient": not obj.requires_grad,
               "name": getattr(obj, "name", None) or ""}
        if obj.dtype == torch.bfloat16:
            out["dtype"] = "bfloat16"
        return out
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            t = to_tensor(obj["data"], dtype=obj.get("dtype"))
            if t.is_floating_point():
                t.stop_gradient = obj.get("stop_gradient", True)
            t.name = obj.get("name", "")
            return t
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (a state dict, or any nest of containers, tensors
    and Python values) to ``path``, making its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """What :func:`save` wrote, tensors on the current device (numpy
    arrays with ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_serializable(obj, return_numpy=return_numpy)
