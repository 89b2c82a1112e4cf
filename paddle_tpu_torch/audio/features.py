"""``paddle.audio.features``: the ``Spectrogram``, ``MelSpectrogram``,
``LogMelSpectrogram`` and ``MFCC`` layers (counterpart of
``paddle_tpu/audio/features.py``).

The pipeline is ``signal.stft`` (frames, window, ``torch.fft.rfft``),
``|.| ** power``, the mel filterbank product and ``power_to_db``, then
the DCT product for MFCCs. The window, filterbank and DCT matrix are
non-persistable buffers, so ``Layer.to`` moves them with the layer and
the state dict holds none of them, as the JAX package's holds none.
"""
from __future__ import annotations

import torch

from .. import signal as _signal
from ..nn.layer.layers import Layer
from . import functional as F

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer("window", F.get_window(
            window, self.win_length, fftbins=True, dtype=dtype),
            persistable=False)

    def forward(self, x):
        spec = _signal.stft(x, self.n_fft, hop_length=self.hop_length,
                            win_length=self.win_length, window=self.window,
                            center=self.center, pad_mode=self.pad_mode,
                            onesided=True)
        mag = spec.abs()
        return mag if self.power == 1.0 else mag.pow(self.power)


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", dtype="float32"):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        dtype)
        self.n_mels = n_mels
        self.register_buffer("fbank", F.compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype),
            persistable=False)

    def forward(self, x):
        spec = self._spectrogram(x)                 # (..., n_freq, T)
        return torch.matmul(self.fbank.to(spec.dtype), spec)


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, ref_value=1.0, amin=1e-10, top_db=None,
                 **kwargs):
        super().__init__()
        self._mel = MelSpectrogram(sr=sr, **kwargs)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        return F.power_to_db(self._mel(x), self.ref_value, self.amin,
                             self.top_db)


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, norm="ortho", dtype="float32",
                 **kwargs):
        super().__init__()
        self._log_mel = LogMelSpectrogram(sr=sr, dtype=dtype, **kwargs)
        self.register_buffer("dct", F.create_dct(
            n_mfcc, self._log_mel._mel.n_mels, norm, dtype),
            persistable=False)

    def forward(self, x):
        logmel = self._log_mel(x)                   # (..., n_mels, T)
        return torch.einsum("mk,...mt->...kt", self.dct.to(logmel.dtype),
                            logmel)
