"""Threefry-2x32 counter-based RNG, bit for bit with ``jax.random``.

The serving engine samples token i of a request with the key
``fold_in(PRNGKey(seed), i)`` and ``categorical`` (Gumbel-max). Sampled
tokens equal the JAX engine's only if these bits do, so this module
reproduces the installed JAX's default ``threefry2x32`` implementation
with ``jax_threefry_partitionable`` on (the JAX 0.9 default): the
Threefry-2x32 hash with 20 rounds, keys as ``(hi, lo)`` uint32 pairs,
random bits from the hash of a 64-bit iota split into ``(hi, lo)``
counter words, and float32 uniforms from the top 23 bits.

PyTorch has no uint32 arithmetic on every backend, so every word is an
int64 tensor holding a value in ``[0, 2**32)``, masked back after each
addition. Keys are ``[..., 2]`` int64 tensors.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``; all int64 tensors of uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey`` of 32-bit integer seeds (any shape):
    ``(0, seed mod 2**32)`` — a 32-bit seed has no high word."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    lo = seed & _MASK
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in`` on ``[..., 2]`` keys and integer data of
    the same batch shape: the hash of counter ``(0, data mod 2**32)``
    under the key."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & _MASK)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key, n: int):
    """32 random bits per draw, ``[..., n]`` for ``[..., 2]`` keys —
    ``jax.random.bits(key, (n,))`` with partitionable threefry: the hash
    of counters ``(0, j)`` for j < n, its two words XORed."""
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(j),
                          j)
    return b0 ^ b1


def uniform(key, n: int, minval: float = 0.0):
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled and
    shifted in float32, then floored at ``minval``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # a fill on the device, not a host copy: the serving step runs
    # inside a CUDA graph, where a host-to-device copy cannot be captured
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def gumbel(key, n: int):
    """``jax.random.gumbel`` in its default ("low") mode, float32."""
    return -torch.log(-torch.log(uniform(key, n, minval=_F32_TINY)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis, one
    draw per key: the first argmax of Gumbel noise plus logits."""
    noise = gumbel(key, logits.shape[-1])
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)
