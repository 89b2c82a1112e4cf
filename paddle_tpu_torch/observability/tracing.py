"""Span-based tracing: ONE annotation, three sinks.

``span("prefill")`` wraps the block in a
``torch.profiler.record_function`` range (it shows in ``torch.profiler``
traces and their Chrome export) and, on the card, an NVTX range (it
shows in Nsight timelines), observes the wall time into a registry
histogram (``pd_host_span_seconds{span=...}``) so the same annotation
shows up in the Prometheus scrape, and emits a flight-recorder slice.

``instrument_jit`` wraps a step function with a first-signature counter
and a call timer: the first call under a new argument signature
(shapes/dtypes of tensor leaves, values of everything else) is what
makes the port build something new — an eager step's first launch of a
shape, or a CUDA graph's capture — so counting fresh signatures counts
them. The engine observes its eager steps and each graph replay this
way, under ``pd_jit_call_seconds{graph}``.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional

from .metrics import Registry, default_registry
from .recorder import default_recorder

__all__ = ["span", "Span", "instrument_jit", "jit_signature"]

SPAN_HISTOGRAM = "pd_host_span_seconds"
JIT_COMPILE_COUNTER = "pd_xla_compiles_total"
JIT_CALL_HISTOGRAM = "pd_jit_call_seconds"


def _nvtx():
    """``torch.cuda.nvtx`` when the card is there, else None (an NVTX
    range needs the CUDA runtime's tools extension)."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.nvtx
    return None


class Span:
    """Context manager: ``record_function`` + NVTX range + latency
    histogram + flight-recorder slice, from one ``name``."""

    def __init__(self, name: str, registry: Optional[Registry] = None):
        self.name = name
        self._reg = registry or default_registry()
        self._range = None
        self._nvtx = None
        self._t0 = None

    def __enter__(self):
        import torch

        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._nvtx = _nvtx()
        if self._nvtx is not None:
            self._nvtx.range_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._nvtx is not None:
            self._nvtx.range_pop()
        self._range.__exit__(*exc)
        self._reg.histogram(
            SPAN_HISTOGRAM,
            "wall time of host spans (same names as the profiler trace)",
            labelnames=("span",)).labels(span=self.name).observe(dt)
        default_recorder().emit("host", self.name, ts=self._t0, dur=dt)
        return False


def span(name: str, registry: Optional[Registry] = None) -> Span:
    return Span(name, registry)


def _flatten(x, out: list) -> None:
    """Leaves of nested lists, tuples and dicts (dict keys sorted)."""
    if isinstance(x, (list, tuple)):
        out.append(("seq", type(x).__name__, len(x)))
        for v in x:
            _flatten(v, out)
    elif isinstance(x, dict):
        out.append(("map", tuple(sorted(x, key=repr))))
        for k in sorted(x, key=repr):
            _flatten(x[k], out)
    else:
        out.append(x)


def jit_signature(args, kwargs) -> tuple:
    """Hashable call signature: (shape, dtype, device) for tensor and
    array leaves, the value itself for everything else, over a plain
    flatten of nested lists, tuples and dicts."""
    leaves: list = []
    _flatten((args, kwargs), leaves)

    def leaf_sig(x):
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            return ("arr", tuple(shape), str(dtype),
                    str(getattr(x, "device", "")))
        return ("val", x)

    return tuple(leaf_sig(l) for l in leaves)


def instrument_jit(fn: Callable, name: str,
                   registry: Optional[Registry] = None,
                   count_compiles: bool = True) -> Callable:
    """Wrap ``fn`` with first-signature and call-time observability.

    Increments ``pd_xla_compiles_total{graph=name}`` whenever a call
    arrives with an argument signature not seen by this wrapper (unless
    ``count_compiles`` is False: a caller that counts its own step
    signatures keeps one source for that family), and observes every
    call's wall time into ``pd_jit_call_seconds{graph=name}``. On the
    card a call's wall time is its host time (launch or replay): the
    device runs on after the call returns.
    """
    reg = registry or default_registry()
    compiles = reg.counter(
        JIT_COMPILE_COUNTER,
        "step signatures launched for the first time by graph name "
        "(with CUDA graphs on: graph captures)",
        labelnames=("graph",)).labels(graph=name) if count_compiles else None
    calls = reg.histogram(
        JIT_CALL_HISTOGRAM, "step-function call wall time by graph name",
        labelnames=("graph",)).labels(graph=name)
    seen = set()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if compiles is None:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            calls.observe(time.perf_counter() - t0)
            return out
        try:
            sig = jit_signature(args, kwargs)
            fresh = sig not in seen   # hashing may raise too
        except TypeError:   # unhashable static arg: count the call only
            sig, fresh = None, False
        if fresh:
            seen.add(sig)
            compiles.inc()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.observe(time.perf_counter() - t0)
        return out

    wrapper.__wrapped_jit__ = fn
    wrapper.signatures_seen = seen
    return wrapper
