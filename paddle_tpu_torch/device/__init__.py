"""``paddle.device`` over ``torch.cuda`` (counterpart of
``paddle_tpu/device/__init__.py``).

Every entry point of the port runs on the card unless its caller asks
for the CPU: :func:`resolve_device` is that rule (``device=None`` means
``cuda``; a machine without CUDA raises instead of quietly running the
model on the host). The rest is Paddle's device API: places,
``synchronize``, ``Stream`` / ``Event`` / ``stream_guard`` /
``current_stream`` (torch's CUDA streams and events), the
``device.cuda`` namespace (device count and properties, the caching
allocator's counters) and the ``is_compiled_with_*`` queries. On a
machine without CUDA the streams and events do nothing and the counters
read 0, as the JAX package's do on a host without an accelerator.
``is_compiled_with_cuda()`` says whether a CUDA card is present: the
port's backend is CUDA (the JAX package, with none, returns False).
"""
from __future__ import annotations

import contextlib

import torch

from ..core.device import (CPUPlace, Place, TPUPlace, current_place,
                           device_count, get_device, is_compiled_with_tpu,
                           resolve_device, set_device, to_torch_device)

__all__ = ["resolve_device", "CPUPlace", "Place", "TPUPlace", "current_place",
           "device_count", "get_device", "is_compiled_with_tpu",
           "set_device", "get_all_device_type", "get_available_device",
           "synchronize", "Stream", "Event", "stream_guard",
           "current_stream", "cuda", "is_compiled_with_cuda",
           "is_compiled_with_rocm", "is_compiled_with_xpu",
           "is_compiled_with_npu", "is_compiled_with_mlu",
           "is_compiled_with_ipu", "is_compiled_with_cinn",
           "get_cudnn_version", "XPUPlace", "NPUPlace", "MLUPlace",
           "IPUPlace", "get_all_custom_device_type",
           "get_available_custom_device"]


def _card() -> bool:
    return torch.cuda.is_available()


def _cuda_device(device):
    """``device`` (a Paddle name, Place, index or None) as a CUDA
    device, or None for the current one."""
    if device is None or isinstance(device, int):
        return device
    return to_torch_device(device)


def get_all_device_type():
    return ["cpu", "gpu"] if _card() else ["cpu"]


def get_available_device():
    return get_device()


def synchronize(device=None):
    """Wait for the card's work (nothing to wait for without one)."""
    if _card():
        torch.cuda.synchronize(_cuda_device(device))


class Stream:
    """A CUDA stream (``priority`` 1 high, 2 normal, Paddle's numbers);
    without a card, a stand-in whose methods do nothing."""

    def __init__(self, device=None, priority=2, stream=None):
        self.device = device
        if stream is not None:
            self.cuda_stream = stream
        elif _card():
            self.cuda_stream = torch.cuda.Stream(
                _cuda_device(device), priority=-1 if priority == 1 else 0)
        else:
            self.cuda_stream = None

    def synchronize(self):
        if self.cuda_stream is not None:
            self.cuda_stream.synchronize()

    def query(self):
        return True if self.cuda_stream is None else self.cuda_stream.query()

    def wait_stream(self, stream):
        if self.cuda_stream is not None:
            self.cuda_stream.wait_stream(stream.cuda_stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def wait_event(self, event):
        if self.cuda_stream is not None and event.cuda_event is not None:
            self.cuda_stream.wait_event(event.cuda_event)


class Event:
    """A CUDA event; ``elapsed_time(end)`` is in milliseconds, as
    torch's. Without a card, a stand-in that is always complete."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self.cuda_event = torch.cuda.Event(
            enable_timing=enable_timing, blocking=blocking,
            interprocess=interprocess) if _card() else None

    def record(self, stream=None):
        if self.cuda_event is not None:
            self.cuda_event.record(
                None if stream is None else stream.cuda_stream)

    def query(self):
        return True if self.cuda_event is None else self.cuda_event.query()

    def synchronize(self):
        if self.cuda_event is not None:
            self.cuda_event.synchronize()

    def elapsed_time(self, end_event) -> float:
        if self.cuda_event is None:
            raise RuntimeError("Event.elapsed_time needs a CUDA device")
        return self.cuda_event.elapsed_time(end_event.cuda_event)


def stream_guard(stream):
    """Run the block on ``stream`` (a no-op scope without a card)."""
    if stream is None or stream.cuda_stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream.cuda_stream)


def current_stream(device=None):
    if not _card():
        return Stream(device)
    return Stream(device, stream=torch.cuda.current_stream(
        _cuda_device(device)))


def _counter(name):
    def read(device=None):
        return int(getattr(torch.cuda, name)(_cuda_device(device))) \
            if _card() else 0

    read.__name__ = name
    read.__doc__ = f"``torch.cuda.{name}`` (0 without a card)."
    return staticmethod(read)


class _CudaNamespace:
    """``paddle.device.cuda``: the card's count, properties and name,
    the caching allocator's counters, streams and events."""

    Stream = Stream
    Event = Event
    synchronize = staticmethod(synchronize)
    current_stream = staticmethod(current_stream)
    stream_guard = staticmethod(stream_guard)
    memory_allocated = _counter("memory_allocated")
    memory_reserved = _counter("memory_reserved")
    max_memory_allocated = _counter("max_memory_allocated")
    max_memory_reserved = _counter("max_memory_reserved")

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def is_available():
        return _card()

    @staticmethod
    def empty_cache():
        if _card():
            torch.cuda.empty_cache()

    @staticmethod
    def get_device_properties(device=None):
        return torch.cuda.get_device_properties(
            _cuda_device(device)) if _card() else None

    @staticmethod
    def get_device_name(device=None):
        return torch.cuda.get_device_name(
            _cuda_device(device)) if _card() else "cpu"


cuda = _CudaNamespace()


def is_compiled_with_cuda():
    """Whether a CUDA card is present: the port's backend is CUDA."""
    return _card()


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_mlu():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def get_cudnn_version():
    return torch.backends.cudnn.version() if _card() else None


class XPUPlace:
    def __init__(self, *a):
        raise RuntimeError("XPU is not available; the port runs on CUDA")


class NPUPlace:
    def __init__(self, *a):
        raise RuntimeError("NPU is not available; the port runs on CUDA")


class MLUPlace:
    def __init__(self, *a):
        raise RuntimeError("MLU is not available; the port runs on CUDA")


class IPUPlace:
    def __init__(self, *a):
        raise RuntimeError("IPU is not available; the port runs on CUDA")


def get_all_custom_device_type():
    return []


def get_available_custom_device():
    return []
