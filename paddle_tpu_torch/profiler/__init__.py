"""``paddle.profiler`` over ``torch.profiler``.

Counterpart of ``paddle_tpu/profiler/__init__.py``: the scheduler's
states (CLOSED / READY / RECORD / RECORD_AND_RETURN), ``Profiler`` with
the same transitions, ``RecordEvent``, ``summary()`` over the recorded
host events, the ``benchmark()`` timer that feeds
``observability.training_metrics``, and the ``on_trace_ready``
handlers.

The device timeline is ``torch.profiler``'s: a READY step prepares a
``torch.profiler.profile`` with the CPU and CUDA activities (CUDA when
the card is there; its warm-up, so that the first recorded step loses
no device events), it traces while the scheduler says RECORD, and
``RecordEvent`` opens a
``torch.profiler.record_function`` range in it (the JAX package uses a
``TraceAnnotation`` in the XPlane trace). ``export_chrome_tracing``
writes the host events as a Chrome trace through
``observability.chrome_trace`` and torch.profiler's own trace beside it
in the same directory. A profiler that fails to start raises: the JAX
package swallows a failed ``start_trace``, the port does not.
"""
from __future__ import annotations

import enum
import os
import pickle
import time
from typing import Optional

import torch

__all__ = ["ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "export_protobuf",
           "load_profiler_result", "RecordEvent", "Profiler", "benchmark",
           "SortedKeys", "SummaryView"]


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0):
    """The state of each step: ``skip_first`` CLOSED steps, then periods
    of ``closed`` CLOSED, ``ready`` READY and ``record`` RECORD steps
    (the last RECORD_AND_RETURN), ``repeat`` times (0: forever)."""
    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        period = closed + ready + record
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """``on_trace_ready`` handler: per capture, the profiler's host
    events and the flight recorder's events as a Chrome trace
    (``<worker>.<n>.pd_trace.json``) and torch.profiler's own trace
    (``<worker>.<n>.pt.trace.json``: host ops, kernels, copies), both in
    ``dir_name``. Load either at ui.perfetto.dev or chrome://tracing."""

    def handler(prof):
        from ..observability.chrome_trace import (host_events_to_events,
                                                  write_chrome_trace)

        os.makedirs(dir_name, exist_ok=True)
        handler._count += 1
        name = worker_name or f"worker_pid{os.getpid()}"
        stem = os.path.join(dir_name, f"{name}.{handler._count}")
        handler.last_path = write_chrome_trace(
            stem + ".pd_trace.json",
            extra_events=host_events_to_events(list(_host_events)))
        handler.last_device_path = None
        if prof._torch_prof is not None:
            handler.last_device_path = stem + ".pt.trace.json"
            prof._torch_prof.export_chrome_trace(handler.last_device_path)
        return handler.last_path

    handler._dir = dir_name
    handler._count = 0
    handler.last_path = None
    handler.last_device_path = None
    return handler


_host_events: list = []  # (name, start, end) while a Profiler records
_collecting = False


class RecordEvent:
    """A host range: a ``torch.profiler.record_function`` range in the
    running trace, and a ``(name, start, end)`` row of the statistics
    that ``Profiler.summary()`` renders while a profiler records."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._ctx = None
        self._t0 = None

    def begin(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None
        if self._t0 is not None and _collecting:
            _host_events.append((self.name, self._t0, time.perf_counter()))
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


_DEVICE_TARGETS = (ProfilerTarget.GPU, ProfilerTarget.TPU)


class Profiler:
    """Runs ``torch.profiler`` over the steps the scheduler records and
    calls ``on_trace_ready(self)`` after each capture. ``targets``
    (default: the CPU, and the card when there is one) picks the
    activities; a device target without a card raises."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False):
        self._scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, ready=0,
                                             record=hi - lo, repeat=1)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        wants_device = targets is None or any(
            t in _DEVICE_TARGETS for t in targets)
        if targets is not None and wants_device \
                and not torch.cuda.is_available():
            raise RuntimeError("a device profiler target needs a CUDA card")
        self._activities = [torch.profiler.ProfilerActivity.CPU]
        if wants_device and torch.cuda.is_available():
            self._activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._dir = getattr(on_trace_ready, "_dir", None) or "./profiler_log"
        self._torch_prof = None
        self._prepared = False
        self._tracing = False

    def start(self):
        _host_events.clear()  # fresh statistics per profiling session
        benchmark().begin()   # the timer's first interval opens here
        self._state = self._scheduler(self._step)
        self._maybe_transition()

    def _prepare_trace(self):
        self._torch_prof = torch.profiler.profile(
            activities=self._activities, record_shapes=self._record_shapes,
            profile_memory=self._profile_memory)
        self._torch_prof.prepare_trace()
        self._prepared = True

    def _start_trace(self):
        if not self._prepared:
            self._prepare_trace()
        self._torch_prof.start_trace()
        self._tracing = True

    def _stop_trace(self, ready=True):
        try:
            self._torch_prof.stop_trace()
        finally:
            self._prepared = self._tracing = False
        if ready and self._on_trace_ready:
            self._on_trace_ready(self)

    def _maybe_transition(self):
        global _collecting
        should_record = self._state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        _collecting = should_record
        if not self._timer_only and not self._tracing:
            if should_record:
                self._start_trace()
            elif self._state is ProfilerState.READY and not self._prepared:
                self._prepare_trace()
        if not should_record and self._tracing:
            self._stop_trace()

    def step(self, num_samples: Optional[int] = None):
        benchmark().step(num_samples)
        self._step += 1
        self._state = self._scheduler(self._step)
        self._maybe_transition()

    def stop(self):
        global _collecting
        _collecting = False
        benchmark().end()
        if self._prepared and not self._tracing:
            # a warm-up that never recorded: end the session, no trace
            self._torch_prof.start_trace()
            self._tracing = True
            self._stop_trace(ready=False)
        if self._tracing:
            self._stop_trace()
        self._state = ProfilerState.CLOSED

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def torch_profiler(self):
        """The last ``torch.profiler.profile`` run (None before one)."""
        return self._torch_prof

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """The host events' table (calls, total, average, max, min), and
        where the device trace went."""
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
        agg = {}
        for name, t0, t1 in _host_events:
            tot, cnt, mx, mn = agg.get(name, (0.0, 0, 0.0, float("inf")))
            d = t1 - t0
            agg[name] = (tot + d, cnt + 1, max(mx, d), min(mn, d))
        lines = [f"{'Event':<40}{'Calls':>8}{'Total':>12}{'Avg':>12}"
                 f"{'Max':>12}{'Min':>12}  ({time_unit})"]
        lines.append("-" * 100)
        for name, (tot, cnt, mx, mn) in sorted(
                agg.items(), key=lambda kv: -kv[1][0]):
            lines.append(f"{name:<40}{cnt:>8}{tot * unit:>12.3f}"
                         f"{tot / cnt * unit:>12.3f}{mx * unit:>12.3f}"
                         f"{mn * unit:>12.3f}")
        lines.append("-" * 100)
        lines.append(f"device timeline: torch.profiler trace in {self._dir} "
                     "(export_chrome_tracing)")
        out = "\n".join(lines)
        print(out)
        return out

    @staticmethod
    def clear_events():
        _host_events.clear()

    @staticmethod
    def events():
        return list(_host_events)


class _Benchmark:
    """Steps and samples per second between ``step()`` calls. Each step
    is also published to the observability registry
    (``pd_training_steps_total`` / ``pd_training_samples_total`` /
    ``pd_training_ips`` / ``pd_training_step_seconds``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._last = None
        self._steps = 0
        self._samples = 0
        self._elapsed = 0.0
        self._obs_reg = None
        self._obs = None

    def begin(self):
        self._last = time.perf_counter()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._elapsed += dt
            self._steps += 1
            if num_samples:
                self._samples += num_samples
            self._publish(dt, num_samples)
        self._last = now

    def _publish(self, dt, num_samples):
        from .. import observability as _obs

        reg = _obs.default_registry()
        if not reg.enabled:
            return
        if self._obs_reg is not reg:  # the default registry was swapped
            self._obs = _obs.training_metrics(reg)
            self._obs_reg = reg
        self._obs["steps"].inc()
        if num_samples:
            self._obs["samples"].inc(num_samples)
        self._obs["step_latency"].observe(dt)
        self._obs["ips"].set(self.ips)

    def end(self):
        self._last = None

    @property
    def ips(self):
        if self._elapsed == 0:
            return 0.0
        if self._samples:
            return self._samples / self._elapsed
        return self._steps / self._elapsed

    def report(self):
        return {"steps": self._steps, "elapsed_s": self._elapsed,
                "ips": self.ips}


_bench = _Benchmark()


def benchmark():
    return _bench


class SortedKeys(enum.Enum):
    """The summary table's sort orders."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """``on_trace_ready`` handler writing the host events to
    ``<dir_name>/<worker_name>.pb`` (a pickle, as the JAX package
    writes it); :func:`load_profiler_result` reads it back."""

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(dir_name, f"{worker_name or 'profile'}.pb")
        with open(path, "wb") as f:
            pickle.dump(list(_host_events), f)
        return path

    return handler


def load_profiler_result(filename: str):
    """The host events written by ``export_protobuf``."""
    with open(filename, "rb") as f:
        return pickle.load(f)
