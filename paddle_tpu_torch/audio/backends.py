"""``paddle.audio.backends``: a numpy WAV codec over the standard
library's ``wave`` (counterpart of ``paddle_tpu/audio/backends.py``;
the same bytes either way, so a file written by one package reads back
equal in the other).

``load`` / ``save`` / ``info`` handle 8-, 16- and 32-bit PCM.
"""
from __future__ import annotations

import wave

import numpy as np

__all__ = ["AudioInfo", "info", "load", "save", "list_available_backends",
           "get_current_backend", "set_backend"]


class AudioInfo:
    def __init__(self, sample_rate, num_samples, num_channels,
                 bits_per_sample, encoding):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def list_available_backends():
    return ["wave"]


def get_current_backend():
    return "wave"


def set_backend(backend_name):
    if backend_name not in ("wave",):
        raise NotImplementedError(
            f"backend {backend_name!r}: only the built-in 'wave' codec "
            "is available")


def info(filepath):
    with wave.open(filepath, "rb") as w:
        return AudioInfo(
            sample_rate=w.getframerate(), num_samples=w.getnframes(),
            num_channels=w.getnchannels(),
            bits_per_sample=w.getsampwidth() * 8,
            encoding=f"PCM_{w.getsampwidth() * 8}")


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """Returns (waveform Tensor [C, T] (channels_first) float32 in [-1, 1]
    on the current device, sample_rate)."""
    from ..core.tensor import to_tensor

    with wave.open(filepath, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        w.setpos(min(frame_offset, n))
        count = n - frame_offset if num_frames < 0 else num_frames
        raw = w.readframes(count)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    arr = np.frombuffer(raw, dt).reshape(-1, ch)
    if normalize:
        if width == 1:
            arr = (arr.astype(np.float32) - 128.0) / 128.0
        else:
            arr = arr.astype(np.float32) / float(2 ** (8 * width - 1))
    if channels_first:
        arr = arr.T
    return to_tensor(np.ascontiguousarray(arr)), sr


def save(filepath, src, sample_rate, channels_first=True,
         encoding="PCM_16", bits_per_sample=16):
    arr = np.asarray(src.numpy() if hasattr(src, "numpy") else src)
    if channels_first:
        arr = arr.T
    if arr.dtype.kind == "f":
        width = bits_per_sample // 8
        scale = float(2 ** (bits_per_sample - 1) - 1)
        arr = np.clip(arr, -1.0, 1.0)
        arr = (arr * scale).astype({2: np.int16, 4: np.int32}[width])
    with wave.open(filepath, "wb") as w:
        w.setnchannels(arr.shape[1] if arr.ndim == 2 else 1)
        w.setsampwidth(arr.dtype.itemsize)
        w.setframerate(int(sample_rate))
        w.writeframes(arr.tobytes())
