"""Tensors across process boundaries through POSIX shared memory
(counterpart of ``paddle_tpu/incubate/multiprocessing/reductions.py``).

``reduce_tensor`` copies the tensor's values once into a named
``multiprocessing.shared_memory`` block (a CUDA tensor: one copy to the
host, as the JAX package copies a device array; no CUDA IPC) and
pickles only the handle: name, shape, dtype, ``stop_gradient`` and the
device type. The receiver maps the same pages: a CPU tensor aliases
them (no copy), a CUDA one is copied to the receiver's current card.
bfloat16 crosses as its uint16 bits. The sending process owns each
block and unlinks it at exit (or ``tensor_shm_unlink_all()``); a
receiver's mapping stays valid after the unlink. ``init_reductions()``
registers the reducer for the port's ``Tensor`` with ``ForkingPickler``
(``incubate.multiprocessing`` does it on import).
"""
from __future__ import annotations

import atexit
from multiprocessing import resource_tracker, shared_memory
from multiprocessing.reduction import ForkingPickler

import numpy as np
import torch

from ...core.tensor import Tensor, as_tensor

__all__ = ["reduce_tensor", "init_reductions", "tensor_shm_unlink_all"]

_OWNED: dict = {}
_BF16 = "__bf16__"


def tensor_shm_unlink_all():
    """Unlink every shared block this process created."""
    for shm in list(_OWNED.values()):
        try:
            shm.close()
            shm.unlink()
        except OSError:
            pass
    _OWNED.clear()


atexit.register(tensor_shm_unlink_all)


def _attach(shm_name):
    """Map the sender's block without adopting it: Python's resource
    tracker registers every attachment and would unlink the block when
    this process exits, under the sender (which owns and unlinks it)."""
    shm = shared_memory.SharedMemory(name=shm_name)
    if shm_name not in _OWNED:
        resource_tracker.unregister(shm._name, "shared_memory")
    return shm


def _rebuild_tensor(shm_name, shape, dtype_str, stop_gradient,
                    device_type="cpu"):
    shm = _attach(shm_name)
    if dtype_str == _BF16:
        arr = np.ndarray(shape, dtype=np.int16, buffer=shm.buf)
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        arr = np.ndarray(shape, dtype=np.dtype(dtype_str), buffer=shm.buf)
        t = torch.from_numpy(arr)
    if device_type != "cpu":
        t = t.to(device_type)
    out = as_tensor(t)
    if not stop_gradient and out.is_floating_point():
        out.requires_grad_(True)
    # the mapping lives as long as the tensor (numpy's buffer does not
    # own the SharedMemory object)
    out._shm_attachment = shm
    return out


def reduce_tensor(t: torch.Tensor):
    """Copy ``t`` into a new shared block; the pickle payload is the
    block's handle."""
    src = t.detach().cpu().contiguous()
    if src.dtype == torch.bfloat16:
        arr, dtype_str = src.view(torch.int16).numpy(), _BF16
    else:
        arr = src.numpy()
        dtype_str = str(arr.dtype)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    np.ndarray(arr.shape, dtype=arr.dtype, buffer=shm.buf)[...] = arr
    _OWNED[shm.name] = shm
    return (_rebuild_tensor, (shm.name, tuple(arr.shape), dtype_str,
                              not t.requires_grad, t.device.type))


_registered = [False]


def init_reductions():
    """Register ``reduce_tensor`` for ``Tensor`` with ``ForkingPickler``:
    a ``Tensor`` put on a ``multiprocessing`` queue or pipe then travels
    as a shared-memory handle."""
    if _registered[0]:
        return
    ForkingPickler.register(Tensor, reduce_tensor)
    _registered[0] = True
