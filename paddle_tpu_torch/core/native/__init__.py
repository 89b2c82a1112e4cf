"""The native queue tier's loader.

Counterpart of ``paddle_tpu/core/native/__init__.py`` for the two
queues the DataLoader uses (the port's own copy of their C++ source is
``csrc/native.cc`` beside this file). The source is built with the
system ``g++`` at first use into ``build/`` (named by the source's hash,
so an edit rebuilds it) and bound with ``ctypes``. Without ``g++``, or
with ``PADDLE_TPU_NATIVE=0``, :func:`load` returns None and the
DataLoader prefetches on a thread instead of worker processes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

__all__ = ["load", "available", "source_path", "BlockingQueue",
           "ShmRingQueue", "Closed", "Timeout"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "native.cc")
_BUILD = os.path.join(_DIR, "build")
ABI_VERSION = 1

_lock = threading.Lock()
_lib = None
_tried = False


def source_path() -> str:
    return _SRC


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"native-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-fvisibility=hidden", _SRC, "-o", tmp, "-lrt"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    P, S, LL, I, D = c.c_void_p, c.c_size_t, c.c_longlong, c.c_int, c.c_double
    sigs = {
        "ptq_create": (P, [S]),
        "ptq_push": (I, [P, c.c_char_p, S, D]),
        "ptq_peek_size": (LL, [P, D]),
        "ptq_pop": (LL, [P, P, S, D]),
        "ptq_size": (S, [P]),
        "ptq_close": (None, [P]),
        "ptq_destroy": (None, [P]),
        "shr_create": (P, [c.c_char_p, S]),
        "shr_open": (P, [c.c_char_p]),
        "shr_push": (I, [P, c.c_char_p, S, D]),
        "shr_pop": (LL, [P, P, S, D]),
        "shr_peek_size": (LL, [P, D]),
        "shr_close_queue": (None, [P]),
        "shr_detach": (None, [P]),
        "shr_unlink": (None, [c.c_char_p]),
        "ptn_abi_version": (I, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def load():
    """The ctypes library, or None when disabled or unbuildable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PADDLE_TPU_NATIVE", "1") == "0":
            return None
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        _bind(lib)
        if lib.ptn_abi_version() != ABI_VERSION:
            raise RuntimeError(f"{so}: ABI {lib.ptn_abi_version()}, "
                               f"expected {ABI_VERSION}")
        _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


from .queues import BlockingQueue, Closed, ShmRingQueue, Timeout  # noqa: E402
