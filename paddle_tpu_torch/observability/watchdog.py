"""Hang watchdog: progress heartbeats + a post-mortem diagnostic dump.

Counterpart of ``paddle_tpu/observability/watchdog.py``. A serving
stall dies silently without it: metrics freeze, nothing captures
state, and the timeline that led into the stall is gone. The watchdog is a daemon thread that polls *progress sources* — callables
returning a monotonically-increasing progress count plus a "busy"
flag — and, when a busy source makes no progress for longer than the
stall deadline, writes a diagnostic bundle and increments
``pd_watchdog_stalls_total`` instead:

- a registry snapshot (every metric),
- the last-K flight-recorder events (the timeline INTO the stall),
- per-request states from the source's ``describe_fn`` (e.g.
  ``GenerationEngine.request_summaries``),
- an optional extra ``native_stats_fn`` snapshot.

An optional callback fires after the dump (page an operator, abort the
request, restart the worker). A source that is idle (``busy_fn()``
False) never fires — no progress is expected of an empty engine — and
a fired source re-arms only after it makes progress again, so one
stall produces one dump, not one per poll.

Configuration (constructor args override env):

- ``PD_OBS_WATCHDOG_DEADLINE`` — stall deadline seconds (default 30)
- ``PD_OBS_WATCHDOG_POLL``     — poll interval seconds (default
  ``min(deadline / 4, 1.0)``)
- ``PD_OBS_WATCHDOG_DIR``      — dump directory (default
  ``$TMPDIR/pd_watchdog``)
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

from .export import to_json
from .metrics import Registry, default_registry
from .recorder import FlightRecorder, default_recorder

__all__ = ["Watchdog", "watch_engine", "default_watchdog",
           "set_default_watchdog", "STALLS_COUNTER"]

STALLS_COUNTER = "pd_watchdog_stalls_total"


class _Source:
    __slots__ = ("name", "progress_fn", "busy_fn", "describe_fn",
                 "last_progress", "last_change", "fired")

    def __init__(self, name, progress_fn, busy_fn, describe_fn):
        self.name = name
        self.progress_fn = progress_fn
        self.busy_fn = busy_fn
        self.describe_fn = describe_fn
        self.last_progress = None
        self.last_change = time.perf_counter()
        self.fired = False


class Watchdog:
    def __init__(self, deadline_s: Optional[float] = None,
                 poll_interval_s: Optional[float] = None,
                 dump_path: Optional[str] = None,
                 callback: Optional[Callable[[str, dict], None]] = None,
                 registry: Optional[Registry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 native_stats_fn: Optional[Callable[[], dict]] = None,
                 last_k: int = 512, start: bool = True):
        if deadline_s is None:
            deadline_s = float(os.environ.get("PD_OBS_WATCHDOG_DEADLINE",
                                              "30"))
        if deadline_s <= 0:
            raise ValueError("watchdog deadline must be > 0 seconds")
        if poll_interval_s is None:
            poll_interval_s = float(os.environ.get(
                "PD_OBS_WATCHDOG_POLL", str(min(deadline_s / 4.0, 1.0))))
        self.deadline_s = deadline_s
        self.poll_interval_s = max(poll_interval_s, 1e-3)
        self._dump_dir = dump_path or os.environ.get(
            "PD_OBS_WATCHDOG_DIR",
            os.path.join(tempfile.gettempdir(), "pd_watchdog"))
        self._callback = callback
        self._registry = registry or default_registry()
        self._recorder = recorder or default_recorder()
        self._native_stats_fn = native_stats_fn
        self._last_k = last_k
        self._counter = self._registry.counter(
            STALLS_COUNTER,
            "stall dumps written by the hang watchdog",
            labelnames=("source",))
        self._sources: Dict[str, _Source] = {}
        self._beats: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_started = time.perf_counter()
        self._n_dumps = 0
        self.last_dump_path: Optional[str] = None
        if start:
            self.start()

    # --------------------------------------------------------- sources --
    def watch(self, name: str, progress_fn: Callable[[], float],
              busy_fn: Callable[[], bool] = lambda: True,
              describe_fn: Optional[Callable[[], dict]] = None) -> None:
        """Register a progress source. ``progress_fn`` must increase
        whenever the component does useful work; ``busy_fn`` gates
        whether progress is currently expected at all."""
        with self._lock:
            self._sources[name] = _Source(name, progress_fn, busy_fn,
                                          describe_fn)

    def heartbeat(self, name: str = "heartbeat") -> None:
        """Manual source: call this from your loop; the watchdog fires
        if a busy period passes ``deadline_s`` without a beat."""
        with self._lock:
            self._beats[name] = self._beats.get(name, 0) + 1
            if name not in self._sources:
                self._sources[name] = _Source(
                    name, lambda n=name: self._beats[n],
                    lambda: True, None)

    # ------------------------------------------------------------ loop --
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        # a fresh event per start: a stop()ped thread may still be in
        # its final pass (stop-from-callback cannot join it), and it
        # must keep seeing ITS set event while the new thread polls
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(self._stop,),
                                        name="pd-watchdog", daemon=True)
        self._thread.start()

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.poll_interval_s):
            try:
                self.check()
            except Exception:   # a racy pass must not kill the daemon
                continue

    def check(self, now: Optional[float] = None) -> bool:
        """One poll pass (the thread calls this; tests may too).
        Returns True when any source fired this pass."""
        now = time.perf_counter() if now is None else now
        fired = False
        with self._lock:
            sources = list(self._sources.values())
        for src in sources:
            try:
                progress = src.progress_fn()
                busy = bool(src.busy_fn())
            except Exception:
                continue    # a torn-down engine must not kill the thread
            if progress != src.last_progress:
                src.last_progress = progress
                src.last_change = now
                src.fired = False
                continue
            if not busy:
                src.last_change = now   # idle: the clock does not run
                continue
            if not src.fired and now - src.last_change >= self.deadline_s:
                src.fired = True
                fired = True
                self._fire(src, now)
        return fired

    # ------------------------------------------------------------ dump --
    def _fire(self, src: _Source, now: float) -> None:
        stall_s = now - src.last_change
        requests = {}
        if src.describe_fn is not None:
            try:
                requests = src.describe_fn()
            except Exception as e:   # partial dump beats no dump
                requests = {"describe_error": repr(e)}
        native = None
        if self._native_stats_fn is not None:
            try:
                native = self._native_stats_fn()
            except Exception as e:
                native = {"native_stats_error": repr(e)}
        dump = {
            "reason": "stall",
            "source": src.name,
            "stall_seconds": stall_s,
            "deadline_seconds": self.deadline_s,
            "wall_time": time.time(),
            "progress": src.last_progress,
            "requests": requests,
            "native_stats": native,
            "registry": to_json(self._registry),
            "events": [e.to_dict() for e in
                       self._recorder.snapshot(last=self._last_k)],
        }
        self._counter.labels(source=src.name).inc()
        self._recorder.emit("watchdog", "stall_dump",
                            source=src.name, stall_s=stall_s)
        # count the firing before attempting the write, so /healthz's
        # stalls_total and pd_watchdog_stalls_total always agree even
        # when the dump directory is unwritable
        self._n_dumps += 1
        path = None
        try:
            os.makedirs(self._dump_dir, exist_ok=True)
            path = os.path.join(
                self._dump_dir,
                f"watchdog_dump_pid{os.getpid()}_{self._n_dumps}.json")
            with open(path, "w") as f:
                json.dump(dump, f)
            self.last_dump_path = path
        except OSError:
            path = None     # counter + callback still carry the signal
        if self._callback is not None:
            try:
                self._callback(path, dump)
            except Exception:
                pass        # a broken pager must not kill the watchdog

    # ---------------------------------------------------------- status --
    def status(self) -> dict:
        """Health summary (what ``/healthz`` serves)."""
        now = time.perf_counter()
        with self._lock:
            sources = {
                name: {"stalled": s.fired,
                       "busy": _safe_bool(s.busy_fn),
                       "seconds_since_progress": now - s.last_change}
                for name, s in self._sources.items()
            }
        return {
            "running": self._thread is not None and self._thread.is_alive(),
            "uptime_seconds": now - self._t_started,
            "deadline_seconds": self.deadline_s,
            "stalled": any(s["stalled"] for s in sources.values()),
            "stalls_total": self._n_dumps,
            "last_dump_path": self.last_dump_path,
            "sources": sources,
        }

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        # a stall callback may call stop() FROM the watchdog thread
        # ("restart the worker"); joining yourself raises — the set
        # event alone ends the loop on its next wakeup
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._thread = None
        with self._lock:
            if _default_watchdog() is self:
                set_default_watchdog(None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _safe_bool(fn) -> bool:
    try:
        return bool(fn())
    except Exception:
        return False


def watch_engine(engine, name: str = "engine", watchdog: Optional[Watchdog]
                 = None, register_default: bool = True,
                 max_finished: int = 32, **kw) -> Watchdog:
    """Wire a :class:`GenerationEngine` to a watchdog (creating one from
    ``**kw`` unless passed): progress = prefills + decode steps +
    finishes, busy = scheduler has queued or running work, and the dump
    carries the live requests' summaries. Finished requests accumulate
    for the process lifetime, so the dump keeps only the newest
    ``max_finished`` of them — a stall dump must stay dump-sized even
    after millions of served requests.

    Async pipelining gets a SECOND source, ``<name>_commit``: under
    ``async_depth > 0`` commits lag dispatches by design, so the
    main (dispatch-side) source alone could miss a wedged pipeline —
    dispatched-step counters advancing while no results ever land. The
    commit source's progress is ``engine.steps_committed`` and it is
    busy ONLY while dispatches are actually in flight, so it neither
    false-fires on the by-design one-step lag (healthy pipelines commit
    every step) nor on an ordinary stall with an empty pipeline (which
    the main source already covers with exactly one dump)."""
    wd = watchdog or Watchdog(**kw)
    sched = engine.scheduler

    def progress():
        s = sched.stats
        # n_chunks: a long chunked prefill ticks per chunk, not once per
        # prompt — mid-train is progress, not a stall
        return (s["n_prefills"] + s.get("n_chunks", 0)
                + s["n_decode_steps"] + s["n_finished"])

    def describe():
        # live requests + the newest finished few — never a scan over
        # everything the process ever served
        out = {}
        for req in list(sched.waiting) + list(sched.running.values()):
            out[str(req.rid)] = engine.request_summary(req.rid)
        for rid in list(sched.recent_finished)[-max_finished:]:
            out[str(rid)] = engine.request_summary(rid)
        return out

    wd.watch(name, progress, busy_fn=lambda: sched.has_work,
             describe_fn=describe)
    if hasattr(engine, "steps_committed"):
        wd.watch(name + "_commit",
                 lambda: engine.steps_committed,
                 busy_fn=lambda: bool(getattr(engine, "_inflight", ())),
                 describe_fn=describe)
    if register_default and _default_watchdog() is None:
        set_default_watchdog(wd)
    return wd


_default: Optional[Watchdog] = None


def _default_watchdog() -> Optional[Watchdog]:
    return _default


def default_watchdog() -> Optional[Watchdog]:
    """The process-default watchdog (what ``/healthz`` reports), or
    None when none has been registered."""
    return _default


def set_default_watchdog(wd: Optional[Watchdog]) -> Optional[Watchdog]:
    global _default
    prev, _default = _default, wd
    return prev
