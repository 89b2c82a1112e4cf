"""``paddle.signal``: ``frame``, ``overlap_add``, ``stft`` and ``istft``
(counterpart of ``paddle_tpu/signal.py``).

Paddle's layouts: ``frame`` along the last axis gives ``(...,
frame_length, num_frames)``, along axis 0 ``(num_frames, frame_length,
...)``; ``stft`` gives ``(..., n_fft // 2 + 1 or n_fft, num_frames)``.
Framing is ``unfold`` (a strided view), overlap-add an ``index_add``
over the frames' positions, and the transforms ``torch.fft``'s, so each
is differentiable through torch's autograd. ``stft`` pads a centred
signal by ``n_fft // 2`` either side (``pad_mode`` ``reflect`` by
default); ``istft`` divides by the overlap-added squared window where
it exceeds 1e-11, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .core.tensor import to_tensor_arg

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _check_axis(axis, ndim, what):
    # Paddle frames and overlap-adds along the first or the last axis
    if axis not in (0, -1, ndim - 1):
        raise ValueError(f"{what} only supports axis 0 or -1, got {axis}")


def _frames(x, frame_length, hop_length, axis=-1):
    frames = x.movedim(axis, -1).unfold(-1, frame_length, hop_length)
    if axis != 0:
        return frames.transpose(-1, -2)             # (..., L, F)
    return frames.movedim((-2, -1), (0, 1))         # (F, L, ...)


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames of ``x`` along ``axis`` (a copy, in Paddle's
    layout)."""
    x = to_tensor_arg(x)
    _check_axis(axis, x.ndim, "frame")
    n = x.shape[axis]
    if frame_length > n:
        raise ValueError(f"frame_length ({frame_length}) > axis size ({n})")
    return _frames(x, int(frame_length), int(hop_length), axis).contiguous()


def _overlap_add(x, hop_length, axis=-1):
    frames = x.transpose(-1, -2) if axis != 0 else \
        x.movedim((0, 1), (-2, -1))                 # (..., F, L)
    num_frames, frame_length = frames.shape[-2], frames.shape[-1]
    out_len = (num_frames - 1) * hop_length + frame_length
    idx = (torch.arange(num_frames, device=x.device)[:, None] * hop_length
           + torch.arange(frame_length, device=x.device)[None, :])
    flat = frames.reshape(*frames.shape[:-2], num_frames * frame_length)
    out = flat.new_zeros(*frames.shape[:-2], out_len).index_add(
        -1, idx.reshape(-1), flat)
    return out if axis != 0 else out.movedim(-1, 0)


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse layout of :func:`frame`: each frame added in at its
    position."""
    x = to_tensor_arg(x)
    _check_axis(axis, x.ndim, "overlap_add")
    return _overlap_add(x, int(hop_length), axis)


def _window(window, win_length, n_fft, device):
    if window is not None:
        win = to_tensor_arg(window).to(device)
    else:
        win = torch.ones(win_length, dtype=torch.float32, device=device)
    if win_length < n_fft:                          # centred in n_fft
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    return win


def _pad(x, pad, mode):
    if mode == "constant":
        return F.pad(x, (pad, pad))
    flat = x.reshape(-1, 1, x.shape[-1])            # reflect wants 3-D
    return F.pad(flat, (pad, pad), mode=mode).reshape(
        *x.shape[:-1], x.shape[-1] + 2 * pad)


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """The short-time Fourier transform of ``x`` (``(..., T)``):
    complex ``(..., n_fft // 2 + 1, num_frames)`` (``n_fft`` rows when
    not ``onesided``)."""
    x = to_tensor_arg(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft "
                         f"({n_fft})")
    win = _window(window, win_length, n_fft, x.device)
    sig = _pad(x, n_fft // 2, pad_mode) if center else x
    frames = _frames(sig, n_fft, hop_length) * win[:, None].to(sig.dtype)
    spec = torch.fft.rfft(frames, dim=-2) if onesided else \
        torch.fft.fft(frames, dim=-2)
    if normalized:
        spec = spec / n_fft ** 0.5
    return spec


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse of :func:`stft`, with the least-squares window
    compensation."""
    x = to_tensor_arg(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft "
                         f"({n_fft})")
    if onesided and return_complex:
        raise ValueError(
            "onesided=True discards the imaginary part; use onesided=False "
            "with return_complex=True")
    win = _window(window, win_length, n_fft, x.device)
    spec = x * n_fft ** 0.5 if normalized else x
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-2)
    else:
        frames = torch.fft.ifft(spec, n=n_fft, dim=-2)
        if not return_complex:
            frames = frames.real
    real = frames.real.dtype if frames.is_complex() else frames.dtype
    sig = _overlap_add(frames * win[:, None].to(real), hop_length)
    num_frames = spec.shape[-1]
    env = _overlap_add((win * win).float()[:, None].expand(
        n_fft, num_frames), hop_length)
    env = torch.where(env > 1e-11, env, torch.ones_like(env)).to(real)
    sig = sig / env
    if center:
        pad = n_fft // 2
        sig = sig[..., pad:]
        if length is None and pad:
            sig = sig[..., :sig.shape[-1] - pad]
    if length is not None:
        sig = sig[..., :length]
    return sig
