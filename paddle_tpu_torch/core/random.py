"""The port's random state: torch generators for initializers and
creation ops, a threefry ``Generator`` for dropout.

Counterpart of ``paddle_tpu/core/random.py``. Two streams:

- one ``torch.Generator`` per device (:func:`generator`): creation ops
  and initializers draw from it, so a model built after ``seed(n)`` is
  the same every time. The numbers are PyTorch's, not ``jax.random``'s:
  weights pass between the packages as arrays, never as seeds.
- the threefry :class:`Generator` (``default_generator``), the JAX
  package's: a key split once per random op (:func:`next_key`), so
  dropout masks equal the JAX package's bit for bit from the same seed.
  Keys are ``[2]`` int64 CPU tensors; splitting them is host arithmetic.

``seed(n)`` reseeds both. ``trace_key_scope`` is the step compiler's
hook (``jit.TrainStep`` pushes each step's key), ``RNGStatesTracker``
the named streams of tensor-parallel dropout, and :func:`record_keys` /
:func:`replay_keys` let a recomputed forward (activation checkpointing)
draw the keys its first run drew without moving any generator, as a
``jax.checkpoint`` replays its traced keys.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import torch

from . import threefry
from .device import to_torch_device

__all__ = ["seed", "generator", "get_rng_state", "set_rng_state",
           "Generator", "default_generator", "next_key", "trace_key_scope",
           "RNGStatesTracker", "record_keys", "replay_keys"]

_GENERATORS: Dict[torch.device, torch.Generator] = {}
_SEED = [0]
_state = threading.local()


def generator(device=None) -> torch.Generator:
    """The default torch generator of ``device`` (the current device if
    ``None``), made at first use from the last ``seed``."""
    dev = to_torch_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(_SEED[0])
        _GENERATORS[dev] = gen
    return gen


class Generator:
    """A threefry key that splits a fresh subkey per random op, as the
    JAX package's ``Generator``."""

    def __init__(self, seed: int = 0):
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        self._key = threefry.prng_key(int(seed))
        self._seed = int(seed)
        return self

    seed = manual_seed

    def get_state(self) -> torch.Tensor:
        return self._key.clone()

    def set_state(self, key) -> None:
        self._key = threefry.as_key(key).clone()

    def next_key(self) -> torch.Tensor:
        trace_keys = getattr(_state, "trace_key_stack", None)
        if trace_keys:
            # inside a step: split from the step's key
            k, sub = threefry.split(trace_keys[-1])
            trace_keys[-1] = k
            return sub
        self._key, sub = threefry.split(self._key)
        return sub


default_generator = Generator(0)


def seed(n: int) -> torch.Generator:
    """``paddle.seed``: reseed every torch generator and the threefry
    generator with ``n``; returns the current device's torch
    generator."""
    _SEED[0] = int(n)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED[0])
    default_generator.manual_seed(_SEED[0])
    return generator()


def get_rng_state(device=None) -> torch.Tensor:
    """The torch generator's state of ``device`` (the initializers')."""
    return generator(device).get_state()


def set_rng_state(state: torch.Tensor, device=None) -> None:
    generator(device).set_state(state)


def next_key() -> torch.Tensor:
    """The key of one random op: replayed inside :func:`replay_keys`,
    else split from the innermost tracker stream or the default
    generator (each of which splits from a ``trace_key_scope`` key
    first, as in the JAX package); recorded inside
    :func:`record_keys`."""
    replay = getattr(_state, "replay_stack", None)
    if replay:
        keys = replay[-1]
        if not keys:
            raise RuntimeError("a recomputed forward drew more random keys "
                               "than its first run")
        return keys.pop(0)
    gens = getattr(_state, "generator_stack", None)
    key = (gens[-1] if gens else default_generator).next_key()
    for keys in getattr(_state, "record_stack", ()):
        keys.append(key)
    return key


def _stack(name: str) -> list:
    if not hasattr(_state, name):
        setattr(_state, name, [])
    return getattr(_state, name)


class trace_key_scope:
    """Random ops inside split their keys from ``key`` (the step
    compiler's per-step key) in place of the generators."""

    def __init__(self, key):
        self._key = threefry.as_key(key)

    def __enter__(self):
        _stack("trace_key_stack").append(self._key)
        return self

    def __exit__(self, *exc):
        _state.trace_key_stack.pop()
        return False


class record_keys:
    """Append every key drawn inside to ``keys``."""

    def __init__(self, keys: List[torch.Tensor]):
        self._keys = keys

    def __enter__(self):
        _stack("record_stack").append(self._keys)
        return self

    def __exit__(self, *exc):
        _state.record_stack.pop()
        return False


class replay_keys:
    """Random ops inside take ``keys`` in order (a copy; the list is
    left as it is) and move no generator."""

    def __init__(self, keys: List[torch.Tensor]):
        self._keys = list(keys)

    def __enter__(self):
        _stack("replay_stack").append(self._keys)
        return self

    def __exit__(self, *exc):
        _state.replay_stack.pop()
        return False


class RNGStatesTracker:
    """Named RNG states for tensor-parallel dropout (a stream per name,
    seeded deterministically), as the JAX package's."""

    def __init__(self):
        self._states: Dict[str, Generator] = {}

    def add(self, name: str, seed: int):
        if name in self._states:
            raise ValueError(f"rng state {name} already exists")
        self._states[name] = Generator(seed)

    def get_states_tracker(self):
        return dict(self._states)

    def set_states_tracker(self, states):
        self._states = dict(states)

    class _Scope:
        def __init__(self, gen):
            self.gen = gen

        def __enter__(self):
            _stack("generator_stack").append(self.gen)
            return self

        def __exit__(self, *exc):
            _state.generator_stack.pop()
            return False

    def rng_state(self, name: str = "model_parallel_rng"):
        if name not in self._states:
            raise ValueError(f"rng state {name} not registered")
        return RNGStatesTracker._Scope(self._states[name])
