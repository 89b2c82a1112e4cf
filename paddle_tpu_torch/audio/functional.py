"""``paddle.audio.functional``: windows, the mel scale, mel filterbanks,
the DCT matrix and ``power_to_db`` (counterpart of
``paddle_tpu/audio/functional.py``).

Windows, filterbanks and the DCT matrix are built on the host in float64
numpy, as the JAX package builds them, and come back as tensors of
``dtype`` on the current device; ``power_to_db`` is torch ops.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import to_numpy, to_tensor, to_tensor_arg

__all__ = [
    "get_window", "hz_to_mel", "mel_to_hz", "mel_frequencies",
    "fft_frequencies", "compute_fbank_matrix", "create_dct", "power_to_db",
]


def _np_window(window, win_length, fftbins=True):
    sym = not fftbins
    n = win_length
    if window in ("hann", "hanning"):
        return _general_cosine(n, [0.5, 0.5], sym)
    if window == "hamming":
        return _general_cosine(n, [0.54, 0.46], sym)
    if window == "blackman":
        return _general_cosine(n, [0.42, 0.5, 0.08], sym)
    if window in ("rect", "rectangular", "boxcar", "ones"):
        return np.ones(n)
    if window == "bartlett":
        m = n + 1 if not sym else n
        w = np.bartlett(m)
        return w[:-1] if not sym else w
    if window == "triang":
        m = n + 1 if not sym else n
        w = _triang(m)
        return w[:-1] if not sym else w
    if isinstance(window, tuple) and window[0] == "gaussian":
        std = window[1]
        m = n + 1 if not sym else n
        k = np.arange(m) - (m - 1) / 2
        w = np.exp(-0.5 * (k / std) ** 2)
        return w[:-1] if not sym else w
    if isinstance(window, tuple) and window[0] in ("tukey", "taylor",
                                                   "kaiser", "exponential"):
        raise NotImplementedError(f"window {window[0]!r} not implemented")
    raise ValueError(f"unknown window {window!r}")


def _general_cosine(n, a, sym):
    # w[x] = sum_k a_k cos(k x), x in [-pi, pi] (hann: a = [0.5, 0.5],
    # zero at the ends)
    m = n + 1 if not sym else n
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * fac)
    return w[:-1] if not sym else w


def _triang(m):
    k = np.arange(1, (m + 1) // 2 + 1)
    if m % 2 == 0:
        w = (2 * k - 1) / m
        return np.concatenate([w, w[::-1]])
    w = 2 * k / (m + 1)
    return np.concatenate([w, w[-2::-1]])


def get_window(window, win_length, fftbins=True, dtype="float32"):
    return to_tensor(_np_window(window, int(win_length), fftbins),
                     dtype=dtype)


def hz_to_mel(freq, htk=False):
    scalar = not isinstance(freq, (np.ndarray, torch.Tensor, list, tuple))
    f = np.asarray(to_numpy(freq) if isinstance(freq, torch.Tensor)
                   else freq, dtype=np.float64)
    if htk:
        mel = 2595.0 * np.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        mel = (f - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        mel = np.where(f >= min_log_hz, min_log_mel + np.log(
            np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return float(mel) if scalar else mel


def mel_to_hz(mel, htk=False):
    scalar = not isinstance(mel, (np.ndarray, torch.Tensor, list, tuple))
    m = np.asarray(to_numpy(mel) if isinstance(mel, torch.Tensor)
                   else mel, dtype=np.float64)
    if htk:
        f = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        f = f_min + f_sp * m
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        f = np.where(m >= min_log_mel,
                     min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return float(f) if scalar else f


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32"):
    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels)
    return to_tensor(mel_to_hz(mels, htk), dtype=dtype)


def fft_frequencies(sr, n_fft, dtype="float32"):
    return to_tensor(np.linspace(0, sr / 2, 1 + n_fft // 2), dtype=dtype)


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32"):
    """Mel filterbank ``(n_mels, 1 + n_fft // 2)``, slaney-normalized by
    default."""
    f_max = f_max or sr / 2.0
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                       n_mels + 2)
    mel_f = mel_to_hz(mels, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return to_tensor(weights, dtype=dtype)


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32"):
    """DCT-II matrix ``(n_mels, n_mfcc)``."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    dct = np.cos(math.pi / n_mels * (n + 0.5) * k)
    if norm == "ortho":
        dct[0] *= 1.0 / math.sqrt(2)
        dct *= math.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return to_tensor(dct.T, dtype=dtype)


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """``10 * log10(spect / ref_value)``, floored at ``amin``; with
    ``top_db``, clipped to ``top_db`` below the largest value of the
    whole tensor."""
    s = to_tensor_arg(spect)
    log_spec = 10.0 * torch.log10(torch.clamp_min(s, amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec
