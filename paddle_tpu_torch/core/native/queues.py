"""Queue wrappers over the native tier (counterpart of
``paddle_tpu/core/native/queues.py``).

``BlockingQueue``: an in-process bounded byte/object queue (falls back
to ``queue.Queue`` without the native library). ``ShmRingQueue``: the
cross-process shared-memory ring of the DataLoader's workers, 64 MiB by
default; a message larger than the ring raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import os
import pickle
import queue as _pyqueue
from typing import Optional

__all__ = ["BlockingQueue", "ShmRingQueue", "Closed", "Timeout"]


class Closed(Exception):
    pass


class Timeout(Exception):
    pass


class BlockingQueue:
    def __init__(self, capacity: int = 8):
        from . import load

        self._lib = load()
        if self._lib is not None:
            self._h = self._lib.ptq_create(capacity)
        else:
            self._q = _pyqueue.Queue(maxsize=capacity)
            self._closed = False

    def push(self, data: bytes, timeout: float = -1.0):
        if self._lib is not None:
            rc = self._lib.ptq_push(self._h, data, len(data), timeout)
            if rc == -1:
                raise Timeout()
            if rc == -2:
                raise Closed()
            return
        if self._closed:
            raise Closed()
        try:
            self._q.put(data, timeout=None if timeout < 0 else timeout)
        except _pyqueue.Full:
            raise Timeout() from None

    def pop(self, timeout: float = -1.0) -> bytes:
        if self._lib is not None:
            n = self._lib.ptq_peek_size(self._h, timeout)
            if n == -1:
                raise Timeout()
            if n == -2:
                raise Closed()
            buf = ctypes.create_string_buffer(int(n))
            got = self._lib.ptq_pop(self._h, buf, int(n), timeout)
            if got == -1:
                raise Timeout()
            if got == -2:
                raise Closed()
            return buf.raw[: int(got)]
        try:
            return self._q.get(timeout=None if timeout < 0 else timeout)
        except _pyqueue.Empty:
            if self._closed:
                raise Closed() from None
            raise Timeout() from None

    def push_obj(self, obj, timeout: float = -1.0):
        self.push(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
                  timeout)

    def pop_obj(self, timeout: float = -1.0):
        return pickle.loads(self.pop(timeout))

    def __len__(self):
        if self._lib is not None:
            return int(self._lib.ptq_size(self._h))
        return self._q.qsize()

    def close(self):
        if self._lib is not None:
            self._lib.ptq_close(self._h)
        else:
            self._closed = True

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.ptq_close(self._h)
            lib.ptq_destroy(self._h)
            self._h = None


class ShmRingQueue:
    """A cross-process byte ring: ``create`` in the parent, ``open_`` (by
    name) in the workers. Needs the native library (check
    ``native.available()`` first)."""

    def __init__(self, handle, name: str, owner: bool):
        from . import load

        self._lib = load()
        self._h = handle
        self.name = name
        self._owner = owner

    @classmethod
    def create(cls, name: Optional[str] = None, ring_bytes: int = 64 << 20):
        from . import load

        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        name = name or f"/ptshm_{os.getpid()}_{id(object()) & 0xffffff:x}"
        h = lib.shr_create(name.encode(), ring_bytes)
        if not h:
            raise RuntimeError(f"shm_open failed for {name}")
        return cls(h, name, owner=True)

    @classmethod
    def open_(cls, name: str):
        from . import load

        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        h = lib.shr_open(name.encode())
        if not h:
            raise RuntimeError(f"shm segment {name} not found")
        return cls(h, name, owner=False)

    def push(self, data: bytes, timeout: float = -1.0):
        rc = self._lib.shr_push(self._h, data, len(data), timeout)
        if rc == -1:
            raise Timeout()
        if rc == -2:
            raise Closed()
        if rc == -4:
            raise ValueError(
                f"message of {len(data)} bytes exceeds ring capacity")

    def pop(self, timeout: float = -1.0) -> bytes:
        n = self._lib.shr_peek_size(self._h, timeout)
        if n == -1:
            raise Timeout()
        if n == -2:
            raise Closed()
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.shr_pop(self._h, buf, int(n), timeout)
        if got == -1:
            raise Timeout()
        if got == -2:
            raise Closed()
        return buf.raw[: int(got)]

    def push_obj(self, obj, timeout: float = -1.0):
        self.push(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
                  timeout)

    def pop_obj(self, timeout: float = -1.0):
        return pickle.loads(self.pop(timeout))

    def close(self):
        if self._h:
            self._lib.shr_close_queue(self._h)

    def destroy(self):
        if self._h:
            # only the owner closes and unlinks: a worker dropping its
            # handle must not tear the queue down for the others
            if self._owner:
                self._lib.shr_close_queue(self._h)
            self._lib.shr_detach(self._h)
            self._h = None
            if self._owner:
                self._lib.shr_unlink(self.name.encode())

    def __del__(self):
        if getattr(self, "_h", None):
            self.destroy()
