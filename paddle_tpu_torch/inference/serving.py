"""The str/int/bytes serving surface of the port's engine and fabric.

Counterpart of ``paddle_tpu/inference/serving.py``: helpers an
embedding host calls with only bytes/str/int arguments. The ``engine_*``
helpers expose a built :class:`~.llm.GenerationEngine` and the
``fabric_*`` helpers a built :class:`~.llm.fabric.ServingFabric`, with
the same ticket semantics and submit return codes: a request id, -1
when admission rejects (queue full), -2 when the submit is malformed,
-3 when the brownout controller is shedding its priority class (retry
after ``engine_retry_after_ms``).

Not ported yet (ROADMAP A.12): ``create``, ``engine_create`` and
``fabric_create`` build over a saved tokens->logits artifact, which
needs the StableHLO ``Predictor``, and ``native_server_record_stats``
mirrors the native C host's counters; each raises
``NotImplementedError`` naming that item. The helpers that drive a
``Predictor`` (``input_names``, ``output_names``, ``set_input``,
``run``, ``get_output``) come with it. Build the engine or fabric
from a ``TorchLM`` instead and pass it to the helpers here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["create", "engine_create", "engine_submit", "engine_wait",
           "engine_cancel", "engine_stats", "engine_request_summary",
           "engine_step_profile", "engine_cost_summary",
           "engine_watchdog", "engine_drain",
           "engine_retry_after_ms", "engine_brownout_level",
           "engine_mesh", "fabric_create", "fabric_submit",
           "fabric_cancel", "fabric_step", "fabric_wait",
           "fabric_drain_replica", "fabric_summary",
           "fabric_metrics_prometheus", "fabric_export_trace",
           "fabric_alerts", "export_chrome_trace", "metrics_prometheus",
           "metrics_serve", "native_server_record_stats",
           "slo_percentiles"]


_NOT_PORTED = ("needs the StableHLO Predictor over a saved artifact, "
               "which the PyTorch port does not have yet (ROADMAP A.12); "
               "build the engine or fabric from a TorchLM instead")


def create(artifact_prefix: str):
    """A ``Predictor`` over a saved artifact: not ported (ROADMAP
    A.12)."""
    raise NotImplementedError(f"create {_NOT_PORTED}")


# ------------------------------------------------ batched generation -----


def engine_create(artifact_prefix: str, max_slots: int = 8,
                  max_seq_len: int = 512, eos_id: int = -1):
    """An engine over a saved tokens->logits artifact: not ported
    (ROADMAP A.12)."""
    raise NotImplementedError(f"engine_create {_NOT_PORTED}")


def engine_submit(engine, tokens: bytes, max_new_tokens: int,
                  priority: int = 0, tenant: str = "default",
                  ttft_deadline_ms: int = 0, deadline_ms: int = 0) -> int:
    """Submit one int32 token-id prompt; returns a ticket (request id),
    -1 when admission control rejects (queue full), -2 when the
    submit is malformed (empty prompt, bad lengths, out-of-range
    priority), or -3 when the brownout controller is shedding this
    priority class — retry after ``engine_retry_after_ms(engine)``.
    ``priority``/``tenant``/deadlines (milliseconds; 0 = none) ride the
    int/str surface."""
    from .llm import InvalidRequest, Overloaded, QueueFull

    prompt = np.frombuffer(tokens, dtype=np.int32).tolist()
    try:
        return engine.submit(prompt, max_new_tokens, priority=priority,
                             tenant=tenant or "default",
                             ttft_deadline_s=ttft_deadline_ms / 1000.0,
                             deadline_s=deadline_ms / 1000.0)
    except Overloaded:                 # before QueueFull — its subclass
        return -3
    except QueueFull:
        return -1
    except InvalidRequest:
        return -2


# ------------------------------------------------- serving fabric -----


def fabric_create(artifact_prefix: str, replicas: int = 0,
                  max_slots: int = 8, max_seq_len: int = 512,
                  eos_id: int = -1, roles: str = ""):
    """A fabric over a saved tokens->logits artifact: not ported
    (ROADMAP A.12)."""
    raise NotImplementedError(f"fabric_create {_NOT_PORTED}")


def fabric_submit(fabric, tokens: bytes, max_new_tokens: int,
                  priority: int = 0, tenant: str = "default",
                  ttft_deadline_ms: int = 0, deadline_ms: int = 0) -> int:
    """Routed submit of one int32 token-id prompt; same ticket/-1/-2/-3
    contract as ``engine_submit`` — the caller cannot tell one engine
    from N behind the surface."""
    from .llm import InvalidRequest, Overloaded, QueueFull

    prompt = np.frombuffer(tokens, dtype=np.int32).tolist()
    try:
        return fabric.submit(prompt, max_new_tokens, priority=priority,
                             tenant=tenant or "default",
                             ttft_deadline_s=ttft_deadline_ms / 1000.0,
                             deadline_s=deadline_ms / 1000.0)
    except Overloaded:                 # before QueueFull — its subclass
        return -3
    except QueueFull:
        return -1
    except InvalidRequest:
        return -2


def fabric_cancel(fabric, ticket: int) -> int:
    """Cancel ``ticket`` wherever it lives (migrations and prefill ->
    decode handoffs followed); 1 if torn down, 0 if unknown or already
    terminal (idempotent)."""
    return 1 if fabric.cancel(ticket) else 0


def fabric_step(fabric) -> int:
    """One fabric step (every replica steps once, handoffs serviced);
    1 while work remains, 0 once idle — the host's drive loop."""
    return 0 if fabric.step() == "idle" else 1


def fabric_wait(fabric, ticket: int) -> bytes:
    """Drive the fabric until ``ticket`` finishes; returns the
    generated int32 token ids as bytes (``engine_wait`` analogue,
    redirect-aware)."""
    if fabric.find_request(ticket) is None:
        raise ValueError(f"unknown ticket {ticket} (rejected, never "
                         "submitted, or from another fabric)")
    while True:
        try:
            return np.asarray(fabric.output_of(ticket),
                              np.int32).tobytes()
        except KeyError:
            pass
        if fabric.step() == "idle":
            raise RuntimeError(f"ticket {ticket} can no longer complete "
                               "(fabric idle)")


def fabric_drain_replica(fabric, index: int) -> int:
    """Drain replica ``index`` (journal flushed, residents preempted),
    replay its live requests onto survivors and respawn the slot.
    Returns the number of requests migrated."""
    return fabric.drain_replica(index)


def fabric_summary(fabric) -> str:
    """Fabric topology + per-replica load as a JSON string (replica
    count, roles, steps, migrations, handoff pages, queue/page load
    per replica)."""
    import json

    return json.dumps(fabric.summary())


def fabric_metrics_prometheus(fabric) -> str:
    """Prometheus text exposition of the fabric's MERGED metrics view:
    every per-replica series re-labelled with ``replica``, counters
    summed into ``replica="all"`` rows, SLO digests re-merged exactly
    and burn-rate gauges riding along."""
    from ..observability import to_prometheus_text

    fabric.obs_view.refresh()
    return to_prometheus_text(fabric.obs_view.registry)


def fabric_export_trace(fabric, path: str) -> str:
    """Dump the fabric's cross-replica merged trace (one Perfetto
    track per request, spanning routing, handoff and migration) as
    Chrome-trace JSON at ``path``; returns ``path``."""
    from ..observability.chrome_trace import write_merged_trace

    return write_merged_trace(path, recorder=fabric._rec)


def fabric_alerts(fabric) -> str:
    """SLO burn-rate alert state as a JSON string: currently firing
    alerts, the last evaluation's per-(tenant, priority) fast/slow
    burn rates, burning replica indices and the per-tenant
    cross-replica usage table."""
    import json

    a = fabric.alerts
    return json.dumps({
        "enabled": a.enabled,
        "objectives": dict(a.objectives),
        "active": a.active(),
        "burn_rates": {"%s/%s" % k: [round(f, 4), round(s, 4)]
                       for k, (f, s) in sorted(a.burn_rates().items())},
        "burning": sorted(a.burning),
        "fires": a.fires,
        "clears": a.clears,
        "tenants": fabric.obs_view.tenant_table(),
    })


def engine_retry_after_ms(engine) -> int:
    """The brownout controller's CURRENT retry-after hint in
    milliseconds — what a client whose submit returned -3 should back
    off; 0 when the engine is not shedding."""
    if getattr(engine, "brownout", None) is None \
            or engine.brownout.level < 4:
        return 0
    return int(round(engine.brownout.retry_after_s() * 1000.0))


def engine_brownout_level(engine) -> int:
    """Current degradation-ladder level (0 = healthy; see
    ``llm.brownout`` for the ladder)."""
    b = getattr(engine, "brownout", None)
    return int(b.level) if b is not None else 0


def engine_mesh(engine) -> str:
    """The engine's tensor-parallel mesh facts as a JSON string, with
    the JAX helper's keys. The port serves on one card: one device,
    index 0, nothing dead, no recovery (the mesh is ROADMAP A.11)."""
    import json

    return json.dumps({
        "devices": 1, "axis": "mp", "device_indices": [0],
        "dead_devices": [], "recoveries": 0, "recovery_enabled": False,
        "policy_mesh_devices": 0, "policy_mesh_axis": "mp",
    })


def engine_drain(engine, finish_residents: int = 0) -> int:
    """Graceful shutdown: stop admission, preempt (or,
    with ``finish_residents != 0``, finish) resident requests, flush +
    fsync the attached journal. Returns the number of live requests
    the journal would restore."""
    return len(engine.drain(finish_residents=bool(finish_residents)))


def engine_cancel(engine, ticket: int) -> int:
    """Cancel ``ticket`` at any lifecycle stage; 1 if torn down, 0 if
    unknown/already terminal (idempotent — safe to re-call)."""
    return 1 if engine.cancel(ticket) else 0


def engine_wait(engine, ticket: int) -> bytes:
    """Drive the engine until ``ticket`` finishes; returns the generated
    int32 token ids as bytes."""
    sched = engine.scheduler
    if ticket not in sched.requests:   # exact: rids this engine issued
        raise ValueError(f"unknown ticket {ticket} (rejected, never "
                         "submitted, or from another engine)")
    while ticket not in engine.scheduler.finished:
        if engine.step() == "idle":
            raise RuntimeError(f"ticket {ticket} can no longer complete "
                               "(engine idle)")
    return np.asarray(engine.output_of(ticket), np.int32).tobytes()


def engine_stats(engine) -> Tuple[int, int, int]:
    """(n_finished, n_decode_steps, xla_compiles): ``xla_compiles`` is
    the engine's captured step graphs (its compiled-step count)."""
    s = engine.scheduler.stats
    return s["n_finished"], s["n_decode_steps"], engine.xla_compiles


def engine_request_summary(engine, ticket: int) -> str:
    """One request's latency breakdown (queue wait, TTFT, decode time,
    tokens, pages) as a JSON string — the str/int surface the host
    relays per ticket."""
    import json

    return json.dumps(engine.request_summary(ticket))


def engine_step_profile(engine, last: int = 32) -> str:
    """The engine's step-phase profile as a JSON string: the
    aggregate summary (per-phase seconds/share, device-idle per token,
    host-overhead ratio) plus the newest ``last`` per-step records."""
    import json

    prof = engine.stepprof
    return json.dumps({
        "summary": prof.summary(),
        "records": [r.to_dict() for r in prof.records(last=last)],
        # async pipelining facts (depth 0 = serial: dispatched ==
        # committed, zero rollbacks, pipeline empty). "occupancy" is
        # the live pipeline-occupancy histogram (index k = mixed steps
        # that held k dispatches in flight after the commit phase),
        # "rollback_reasons" the per-cause rollback counts, and
        # "gap_by_depth" the profiler's per-occupancy median idle gaps
        "async": {
            "depth": getattr(engine, "async_depth", 0),
            "pipeline_depth": getattr(engine, "pipeline_depth", 0),
            "steps_dispatched": getattr(engine, "steps_dispatched", 0),
            "steps_committed": getattr(engine, "steps_committed", 0),
            "rollbacks": getattr(engine, "async_rollbacks", 0),
            "rollback_reasons": dict(
                getattr(engine, "async_rollback_reasons", {})),
            "occupancy": list(getattr(engine, "occupancy_hist", [])),
            "gap_by_depth": {
                str(d): v for d, v in (prof.gap_depth_profile()
                                       if hasattr(prof,
                                                  "gap_depth_profile")
                                       else {}).items()},
            "page_table_uploads": getattr(engine, "pt_uploads", 0),
        },
    })


def engine_cost_summary(engine) -> str:
    """The engine's cost-ledger snapshot as a JSON string: modeled
    device-byte / FLOP totals, per-tenant attribution (sums exactly equal
    the totals), traffic-component breakdown, compile-observatory
    hit/miss books and the per-graph captures.
    ``{"enabled": false}`` when the ledger is off
    (``PD_COST_LEDGER=0``)."""
    import json

    ledger = getattr(engine, "ledger", None)
    if ledger is None:
        return json.dumps({"enabled": False})
    out = {"enabled": True}
    out.update(ledger.summary())
    return json.dumps(out)


def slo_percentiles() -> str:
    """The per-{tenant, priority} SLO digest (true p50/p90/p99 of
    TTFT, inter-token latency and queue wait) as a JSON string."""
    import json

    from ..observability.stepprof import default_slo_digest

    return json.dumps(default_slo_digest().snapshot())


def engine_watchdog(engine, deadline_s: float = 30.0,
                    dump_path: str = ""):
    """Attach a hang watchdog to ``engine``: a busy-but-stalled engine
    writes a diagnostic bundle (registry snapshot + flight-recorder
    tail + per-request states) under ``dump_path`` within
    ``deadline_s``. Returns the watchdog handle (call ``.stop()``)."""
    from ..observability.watchdog import watch_engine

    return watch_engine(engine, deadline_s=deadline_s,
                        dump_path=dump_path or None)


def export_chrome_trace(path: str) -> str:
    """Dump the flight recorder as Chrome-trace JSON at ``path``
    (Perfetto-loadable); returns ``path``."""
    from ..observability.chrome_trace import write_chrome_trace

    return write_chrome_trace(path)


# ------------------------------------------------- observability bridge --


def metrics_prometheus() -> str:
    """Prometheus text exposition of the default registry — the str/int
    surface an embedding host can relay to its own scrape endpoint."""
    from ..observability import to_prometheus_text

    return to_prometheus_text()


_metrics_server = None


def metrics_serve(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start (or return) the in-process ``/metrics`` endpoint; returns
    the bound port. One server per process — repeat calls are no-ops."""
    global _metrics_server
    from ..observability import start_metrics_server

    if _metrics_server is None:
        _metrics_server = start_metrics_server(host=host, port=port)
    return _metrics_server.port


def native_server_record_stats(n_batches: int, n_requests: int,
                               n_submitted: int, n_rejected: int,
                               n_completed: int,
                               server_key: str = "default") -> None:
    """Mirrors the native C host's counters: not ported (ROADMAP
    A.12, with the native host)."""
    raise NotImplementedError(
        "native_server_record_stats mirrors the native C host, which the "
        "PyTorch port does not have yet (ROADMAP A.12)")