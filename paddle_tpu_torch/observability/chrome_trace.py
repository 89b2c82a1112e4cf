"""Chrome trace-event (Perfetto-loadable) export of flight-recorder
events.

Renders a :class:`~.recorder.FlightRecorder` snapshot as the standard
`Trace Event Format` JSON object (``{"traceEvents": [...]}``) that
``chrome://tracing``, Perfetto's trace viewer (ui.perfetto.dev) and
TensorBoard's trace plugin all load directly:

- one track (pid ``REQUEST_PID``, tid = request id) per request, so a
  request's queued→prefill→decode→finished lifecycle reads as one
  horizontal lane;
- one track per non-request category (engine decode steps, cache page
  churn, host spans, profiler host events) under pid ``HOST_PID``;
- slices (``dur > 0``) as complete events (``ph: "X"``), moments as
  thread-scoped instants (``ph: "i"``); ``M`` metadata events name the
  processes and tracks.

Timestamps are rebased to the earliest event and converted to the
format's microseconds, so traces start at t=0 regardless of process
uptime.

:func:`merge_traces` is the serving fabric's view: one track per
logical request (pid ``FABRIC_PID``), grouped by the ``trace`` attr the
fabric's tracer stamps on every hop, across replicas.

:func:`merge_device_trace` lays the device trace that
``torch.profiler`` exports (``prof.export_chrome_trace(path)``: kernels,
copies and memsets on the card's streams) beside such a host trace,
under pid ``DEVICE_PID``, one track per stream.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .recorder import Event, FlightRecorder, default_recorder

__all__ = ["to_chrome_trace", "write_chrome_trace", "host_events_to_events",
           "REQUEST_PID", "HOST_PID", "FABRIC_PID", "DEVICE_PID",
           "merge_device_trace", "merge_traces", "write_merged_trace"]

REQUEST_PID = 1
HOST_PID = 2
FABRIC_PID = 3
DEVICE_PID = 4
# the categories of a torch.profiler Chrome export that ran on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def host_events_to_events(host_events: Iterable[Tuple[str, float, float]],
                          cat: str = "profiler") -> List[Event]:
    """Adapt the profiler's ``(name, t0, t1)`` host-event tuples (same
    ``perf_counter`` clock) into recorder events."""
    return [Event(t0, cat, name, None, t1 - t0, ()) for name, t0, t1
            in host_events]


def _attr_args(ev: Event) -> dict:
    args = {k: v for k, v in ev.attrs}
    if ev.rid is not None:
        args["rid"] = ev.rid
    return args


def to_chrome_trace(events: Optional[Sequence[Event]] = None,
                    recorder: Optional[FlightRecorder] = None,
                    extra_events: Sequence[Event] = ()) -> dict:
    """Build the trace-event JSON object from ``events`` (default: a
    snapshot of ``recorder`` / the default recorder) plus any
    ``extra_events`` (e.g. profiler host events)."""
    if events is None:
        events = (recorder or default_recorder()).snapshot()
    evs = sorted(list(events) + list(extra_events), key=lambda e: e.ts)

    trace: List[dict] = [
        {"ph": "M", "ts": 0, "pid": REQUEST_PID, "tid": 0,
         "name": "process_name", "args": {"name": "serving requests"}},
        {"ph": "M", "ts": 0, "pid": HOST_PID, "tid": 0,
         "name": "process_name", "args": {"name": "host"}},
    ]
    if not evs:
        return {"traceEvents": trace, "displayTimeUnit": "ms"}

    base = evs[0].ts
    host_tids: Dict[str, int] = {}
    seen_rids: Dict[int, bool] = {}
    for ev in evs:
        if ev.rid is not None and ev.cat == "request":
            pid, tid = REQUEST_PID, int(ev.rid)
            if tid not in seen_rids:
                seen_rids[tid] = True
                trace.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                              "name": "thread_name",
                              "args": {"name": f"request {tid}"}})
        else:
            pid = HOST_PID
            tid = host_tids.get(ev.cat)
            if tid is None:
                tid = host_tids[ev.cat] = len(host_tids) + 1
                trace.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                              "name": "thread_name",
                              "args": {"name": ev.cat}})
        rec = {"name": ev.name, "cat": ev.cat, "pid": pid, "tid": tid,
               "ts": (ev.ts - base) * 1e6, "args": _attr_args(ev)}
        if ev.dur > 0.0:
            rec["ph"] = "X"
            rec["dur"] = ev.dur * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"          # thread-scoped instant
        trace.append(rec)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       events: Optional[Sequence[Event]] = None,
                       recorder: Optional[FlightRecorder] = None,
                       extra_events: Sequence[Event] = ()) -> str:
    """Dump :func:`to_chrome_trace` to ``path``; load the file at
    ui.perfetto.dev (or chrome://tracing) to browse it."""
    obj = to_chrome_trace(events=events, recorder=recorder,
                          extra_events=extra_events)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def merge_traces(events: Optional[Sequence[Event]] = None,
                 recorder: Optional[FlightRecorder] = None) -> dict:
    """Cross-replica per-request tracks: the fabric view of a trace.

    :func:`to_chrome_trace` lanes events by rid, but a fabric request
    changes rid at every relocation (prefill ticket -> decode rid, kill
    -> replayed rid). The fabric tracer stamps every hop of a request's
    lineage with the same ``trace`` attr (and ``replica`` and a rising
    ``hop``); this export groups by it: one track (pid ``FABRIC_PID``,
    one tid per trace id in first-seen order) per logical request.
    Per-replica lifecycle slices are renamed ``{name}@r{replica}``.
    Events without a ``trace`` attr are ignored; with none the result
    is the metadata header alone, still valid JSON."""
    if events is None:
        events = (recorder or default_recorder()).snapshot()
    evs = sorted(events, key=lambda e: e.ts)
    trace: List[dict] = [
        {"ph": "M", "ts": 0, "pid": FABRIC_PID, "tid": 0,
         "name": "process_name", "args": {"name": "fabric requests"}},
    ]
    traced = [ev for ev in evs if ev.attr("trace") is not None]
    if not traced:
        return {"traceEvents": trace, "displayTimeUnit": "ms"}
    base = traced[0].ts
    tids: Dict[str, int] = {}
    for ev in traced:
        tid = tids.get(ev.attr("trace"))
        if tid is None:
            tid = tids[ev.attr("trace")] = len(tids) + 1
            trace.append({"ph": "M", "ts": 0, "pid": FABRIC_PID,
                          "tid": tid, "name": "thread_name",
                          "args": {"name": f"trace {ev.attr('trace')}"}})
        replica = ev.attr("replica")
        name = ev.name
        if ev.cat == "request" and replica is not None:
            name = f"{name}@r{replica}"
        rec = {"name": name, "cat": ev.cat, "pid": FABRIC_PID,
               "tid": tid, "ts": (ev.ts - base) * 1e6,
               "args": _attr_args(ev)}
        if ev.dur > 0.0:
            rec["ph"] = "X"
            rec["dur"] = ev.dur * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        trace.append(rec)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_merged_trace(path: str,
                       events: Optional[Sequence[Event]] = None,
                       recorder: Optional[FlightRecorder] = None) -> str:
    """Dump :func:`merge_traces` to ``path``."""
    obj = merge_traces(events=events, recorder=recorder)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def merge_device_trace(host_trace: dict, device_trace,
                       offset_us: float = 0.0) -> dict:
    """``host_trace`` (a :func:`to_chrome_trace` object) with the device
    events of ``device_trace`` — a ``torch.profiler`` Chrome export, as
    a path or its loaded dict — added under pid ``DEVICE_PID``, one
    track per stream (the export's ``tid``). The two clocks share no
    epoch here, so the device events are rebased to start at
    ``offset_us`` on the host trace's time axis (0 = the host trace's
    first event); pass the host-side start of the profiled region to
    line them up. Returns a new object; the inputs are not modified."""
    if isinstance(device_trace, (str, bytes)) or hasattr(device_trace,
                                                         "__fspath__"):
        with open(device_trace) as f:
            device_trace = json.load(f)
    events = device_trace.get("traceEvents", []) \
        if isinstance(device_trace, dict) else list(device_trace)
    dev = [e for e in events
           if e.get("cat") in DEVICE_CATS and "ts" in e]
    out = {"traceEvents": list(host_trace.get("traceEvents", [])),
           "displayTimeUnit": host_trace.get("displayTimeUnit", "ms")}
    if not dev:
        return out
    out["traceEvents"].append(
        {"ph": "M", "ts": 0, "pid": DEVICE_PID, "tid": 0,
         "name": "process_name", "args": {"name": "device"}})
    base = min(float(e["ts"]) for e in dev)
    streams: Dict[object, int] = {}
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        tid = streams.get(e.get("tid"))
        if tid is None:
            tid = streams[e.get("tid")] = len(streams) + 1
            out["traceEvents"].append(
                {"ph": "M", "ts": 0, "pid": DEVICE_PID, "tid": tid,
                 "name": "thread_name",
                 "args": {"name": f"stream {e.get('tid')}"}})
        rec = {"name": e.get("name", ""), "cat": e["cat"],
               "pid": DEVICE_PID, "tid": tid,
               "ts": float(e["ts"]) - base + offset_us,
               "args": dict(e.get("args", {}))}
        if float(e.get("dur", 0.0)) > 0.0:
            rec["ph"] = "X"
            rec["dur"] = float(e["dur"])
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out["traceEvents"].append(rec)
    return out
