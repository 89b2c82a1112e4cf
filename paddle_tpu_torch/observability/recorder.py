"""Flight recorder: a bounded, thread-safe ring buffer of structured
events.

Aggregate metrics (``metrics.py``) answer "is p99 TTFT regressing";
the flight recorder answers "why was request 4711 slow" — every
lifecycle transition (queued, admitted, prefill, decode progress,
backpressure, finished) is an :class:`Event` with a monotonic
timestamp, a category, an optional request id and free-form attrs, so
any request's timeline is reconstructable after the fact and the last
K events survive for post-mortems (the hang watchdog dumps them).

Hot-path cost model, same contract as the metrics registry:

- **disabled**: one attribute load + one branch (``PD_OBS_DISABLED=1``
  disables the default recorder at import; ``disable()`` at runtime).
- **enabled**: one branch + one tuple construction + one
  ``deque.append`` — the deque's ``maxlen`` does the ring eviction, no
  lock is taken on the emit path (CPython deque append is atomic), and
  nothing is formatted or serialized until somebody exports.

The ring capacity comes from ``PD_OBS_RECORDER_CAPACITY`` (default
65536 events ≈ a few minutes of serving at smoke scale); per-request
decode progress is sampled every ``PD_OBS_DECODE_EVERY`` tokens
(default 8) so long generations do not flood the ring.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Event", "FlightRecorder", "default_recorder",
           "set_default_recorder", "RECORDER_CAPACITY",
           "DECODE_PROGRESS_EVERY"]

RECORDER_CAPACITY = max(
    16, int(os.environ.get("PD_OBS_RECORDER_CAPACITY", "65536")))
DECODE_PROGRESS_EVERY = max(
    1, int(os.environ.get("PD_OBS_DECODE_EVERY", "8")))


class Event(NamedTuple):
    """One recorded moment (``dur == 0``) or slice (``dur > 0``).

    ``ts``/``dur`` are ``time.perf_counter()`` seconds — the same clock
    every other instrumentation point in the repo uses, so recorder
    events, profiler host events and metric timers all line up.
    """

    ts: float
    cat: str                      # "request" | "engine" | "cache" | "host" | ...
    name: str                     # "queued", "prefill", "decode_step", ...
    rid: Optional[int]            # request id, None for non-request events
    dur: float                    # seconds; 0.0 for instant events
    attrs: Tuple[Tuple[str, object], ...]

    def to_dict(self) -> dict:
        return {"ts": self.ts, "cat": self.cat, "name": self.name,
                "rid": self.rid, "dur": self.dur,
                "attrs": dict(self.attrs)}

    def attr(self, key: str, default=None):
        """First attr value stored under ``key`` (attrs are an ordered
        tuple of pairs, not a dict — this is the linear lookup)."""
        for k, v in self.attrs:
            if k == key:
                return v
        return default


class FlightRecorder:
    """Bounded ring of :class:`Event`; oldest events are evicted first."""

    def __init__(self, capacity: int = RECORDER_CAPACITY,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("recorder capacity must be >= 1")
        self._buf: deque = deque(maxlen=capacity)
        self._enabled = bool(enabled)
        self._capacity = capacity

    # ----------------------------------------------------------- state --
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return len(self._buf)

    # ------------------------------------------------------------ emit --
    def emit(self, cat: str, name: str, rid: Optional[int] = None,
             ts: Optional[float] = None, dur: float = 0.0,
             **attrs) -> None:
        """Record one event. ``ts`` defaults to now; pass an earlier
        ``ts`` plus ``dur`` to record a completed slice."""
        if not self._enabled:
            return
        self._buf.append(Event(
            ts if ts is not None else time.perf_counter(),
            cat, name, rid, dur, tuple(attrs.items())))

    def complete(self, cat: str, name: str, t0: float,
                 rid: Optional[int] = None, **attrs) -> None:
        """Record a slice that started at ``t0`` and ends now."""
        if not self._enabled:
            return
        now = time.perf_counter()
        self._buf.append(Event(t0, cat, name, rid, now - t0,
                               tuple(attrs.items())))

    # ----------------------------------------------------------- query --
    def snapshot(self, last: Optional[int] = None) -> List[Event]:
        """Events oldest-first; ``last=K`` keeps only the newest K.

        Lock-free against the emit path: copying retries if a
        concurrent emit mutates the deque mid-copy (rare — the copy is
        one C call — but a GC pause inside it can yield the GIL). After
        the retries it returns whatever the final attempt yields,
        possibly empty, rather than raising into the caller (the
        watchdog thread must survive any race here).
        """
        if last is not None and last <= 0:
            return []
        evs: List[Event] = []
        for _ in range(8):
            try:
                evs = list(self._buf)
                break
            except RuntimeError:    # deque mutated during iteration
                continue
        if last is not None and last < len(evs):
            evs = evs[-last:]
        return evs

    def events_for(self, rid: int) -> List[Event]:
        return [e for e in self.snapshot() if e.rid == rid]

    def by_category(self, cat: str) -> List[Event]:
        return [e for e in self.snapshot() if e.cat == cat]

    def request_ids(self) -> List[int]:
        """Distinct rids still present in the ring, ascending."""
        return sorted({e.rid for e in self.snapshot()
                       if e.rid is not None})

    def clear(self) -> None:
        self._buf.clear()


_default = FlightRecorder(
    enabled=os.environ.get("PD_OBS_DISABLED", "0") != "1")


def default_recorder() -> FlightRecorder:
    return _default


def set_default_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process default (tests/benches); returns the previous
    one. Components bind the recorder at construction, so swap BEFORE
    building the engine whose events you want isolated."""
    global _default
    prev, _default = _default, recorder
    return prev
