"""Threefry-2x32 counter-based RNG, bit for bit with ``jax.random``.

The serving engine samples token i of a request with the key
``fold_in(PRNGKey(seed), i)`` and ``categorical`` (Gumbel-max), and
dropout keeps an element where ``bernoulli(key, 1 - p, shape)`` says so.
These bits equal the JAX package's only if this module reproduces the
installed JAX's default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the JAX 0.9 default): the
Threefry-2x32 hash with 20 rounds, keys as ``(hi, lo)`` uint32 pairs,
random bits from the hash of the 64-bit row-major flat index of each
element split into ``(hi, lo)`` counter words (the two output words
XORed), float32 uniforms from the top 23 bits, and ``split(key, n)``
as the hash of counters ``(0, i)``.

PyTorch has no uint32 arithmetic on every backend, so every word of a
tensor is an int64 holding a value in ``[0, 2**32)``, masked back after
each addition. Keys are ``[..., 2]`` int64 tensors. Splitting a key (a
few hashes) runs on Python integers on the host, so that drawing keys
never waits on or launches work on a device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "bernoulli", "gumbel", "categorical", "key_words",
           "as_key"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``; int64 tensors of uint32 values broadcast together, or
    Python integers. Returns the two output words.

    One loop serves both: its augmented assignments rebind integers and
    update tensors in place, on copies made before the rounds, which
    takes a third of the host time of the out-of-place form (the CPU
    tests draw dropout and sampling bits at full vocabulary widths)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    if isinstance(x0, torch.Tensor) or isinstance(x1, torch.Tensor):
        x0, x1 = (w.clone(memory_format=torch.contiguous_format) for w in
                  torch.broadcast_tensors(torch.as_tensor(x0),
                                          torch.as_tensor(x1)))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x0 &= _MASK
            left = x1 << r
            x1 >>= 32 - r
            x1 |= left
            x1 &= _MASK
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x0 &= _MASK
        x1 += ks[(i + 2) % 3] + i + 1
        x1 &= _MASK
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey`` of 32-bit integer seeds (any shape):
    ``(0, seed mod 2**32)`` — a 32-bit seed has no high word."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    lo = seed & _MASK
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def key_words(key) -> Tuple[int, int]:
    """The two words of one key (a ``[2]`` tensor, array or pair) as
    Python integers."""
    hi, lo = (torch.as_tensor(key).reshape(2).tolist())
    return int(hi) & _MASK, int(lo) & _MASK


def as_key(words, device=None) -> torch.Tensor:
    """A ``[2]`` int64 key tensor from two words (or anything
    :func:`key_words` reads)."""
    if isinstance(words, torch.Tensor) and words.dtype == torch.int64 \
            and words.shape == (2,):
        return words if device is None else words.to(device)
    return torch.tensor(key_words(words), dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in`` on ``[..., 2]`` keys and integer data of
    the same batch shape: the hash of counter ``(0, data mod 2**32)``
    under the key."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & _MASK)
    return torch.stack([o0, o1], dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key: ``[num, 2]``, row i the
    hash of counter ``(0, i)`` (partitionable threefry), on the key's
    device. Hashed on the host with Python integers."""
    k1, k2 = key_words(key)
    rows = [threefry2x32(k1, k2, 0, i) for i in range(int(num))]
    dev = key.device if isinstance(key, torch.Tensor) else None
    return torch.tensor(rows, dtype=torch.int64, device=dev).reshape(num, 2)


def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def random_bits(key, shape: Union[int, Sequence[int]], start: int = 0,
                count: int = None):
    """32 random bits per element, ``key.shape[:-1] + shape`` for
    ``[..., 2]`` keys — ``jax.random.bits(key, shape)`` with
    partitionable threefry: the hash of each element's row-major flat
    index j as counter ``(j >> 32, j mod 2**32)``, its two words XORed.
    ``start`` / ``count`` give only the flat indices ``[start, start +
    count)`` (a 1-d ``[..., count]`` result)."""
    shape = _shape(shape)
    n = math.prod(shape)
    if count is None:
        start, count = 0, n
    j = torch.arange(start, start + count, dtype=torch.int64,
                     device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], j >> 32, j & _MASK)
    bits = b0 ^ b1
    if count == n and start == 0:
        return bits.reshape(key.shape[:-1] + shape)
    return bits


def _unit_floats(bits):
    """The top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def uniform(key, shape: Union[int, Sequence[int]], minval: float = 0.0):
    """``jax.random.uniform(key, shape, float32, minval, 1.0)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled and
    shifted in float32, then floored at ``minval``."""
    floats = _unit_floats(random_bits(key, shape))
    # a fill on the device, not a host copy: the serving step runs
    # inside a CUDA graph, where a host-to-device copy cannot be captured
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def bernoulli(key, p: float, shape: Union[int, Sequence[int]], start: int = 0,
              count: int = None):
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform(key, shape) < float32(p)`` (the uniform's minval 0 leaves
    the floats as they are). ``start`` / ``count`` give the flat indices
    ``[start, start + count)`` only, as :func:`random_bits`."""
    thr = torch.tensor(p, dtype=torch.float32, device=key.device)
    return _unit_floats(random_bits(key, shape, start, count)) < thr


def gumbel(key, shape: Union[int, Sequence[int]]):
    """``jax.random.gumbel`` in its default ("low") mode, float32."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_F32_TINY)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis. A
    ``[..., 2]`` batch of keys draws one sample per key over the
    matching rows of ``logits`` (noise over the last axis per key); a
    single ``[2]`` key draws every row, with noise over the whole shape
    of ``logits`` (flat index across the rows), as JAX does for batched
    logits."""
    shape = logits.shape if key.dim() == 1 else logits.shape[-1]
    noise = gumbel(key, shape)
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)
