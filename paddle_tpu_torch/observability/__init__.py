"""Runtime metrics, flight recorder, step profiler, cost ledger,
tracing and watchdog of the port (``paddle_tpu_torch.observability``).

Counterpart of ``paddle_tpu/observability``, the serving engine's
observability substrate, in plain Python and ``torch`` (the port keeps
its own copy; it reads nothing of the JAX package):

- :mod:`.metrics` — thread-safe ``Counter``/``Gauge``/``Histogram``
  with labels and fixed log-spaced buckets; one branch when disabled
  (``PD_OBS_DISABLED=1`` or ``disable()``).
- :mod:`.export` — Prometheus text exposition, JSON snapshot, and an
  optional stdlib ``http.server`` ``/metrics`` endpoint.
- :mod:`.tracing` — ``span()``: a ``torch.profiler.record_function``
  range plus an NVTX range plus a registry latency histogram, and
  ``instrument_jit()``, a first-signature counter and call timer for
  any step function (the engine's eager step and graph replays).
- :mod:`.recorder` — the flight recorder, a bounded ring of structured
  events (request lifecycle, host phases, cache page churn).
- :mod:`.chrome_trace` — the recorder as Chrome trace-event JSON, and
  its merge with the device trace ``torch.profiler`` exports.
- :mod:`.stepprof` — the step-phase profiler (host phases, the
  device's busy and idle time from CUDA events) and the SLO digests.
- :mod:`.ledger` — the modelled HBM bytes and FLOPs of every step,
  attributed per tenant, and the graph-capture observatory.
- :mod:`.watchdog` — the hang watchdog and its diagnostic dump.

The fabric plane (``fabricobs``, ``alerts``) and the training and
native-host metric families are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .metrics import (Counter, Gauge, Histogram, Registry,
                      DEFAULT_LATENCY_BUCKETS, default_registry, enabled,
                      log_buckets, set_default_registry)
from .metrics import disable as _disable_metrics
from .metrics import enable as _enable_metrics
from .export import (MetricsServer, register_collect_hook,
                     start_metrics_server, to_json, to_prometheus_text,
                     unregister_collect_hook, write_prometheus)
from .tracing import Span, instrument_jit, jit_signature, span
from .recorder import (Event, FlightRecorder, default_recorder,
                       set_default_recorder)
from .chrome_trace import (host_events_to_events, merge_device_trace,
                           to_chrome_trace, write_chrome_trace)
from .stepprof import (PHASES, QuantileDigest, SLODigest, StepProfiler,
                       StepRecord, default_slo_digest,
                       set_default_slo_digest, step_metrics)
from .watchdog import (Watchdog, default_watchdog, set_default_watchdog,
                       watch_engine)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Span", "MetricsServer",
    "DEFAULT_LATENCY_BUCKETS", "default_registry", "set_default_registry",
    "enable", "disable", "enabled", "log_buckets",
    "to_prometheus_text", "to_json", "write_prometheus",
    "start_metrics_server", "span", "instrument_jit", "jit_signature",
    "serving_metrics", "ledger_metrics",
    "Event", "FlightRecorder", "default_recorder", "set_default_recorder",
    "to_chrome_trace", "write_chrome_trace", "host_events_to_events",
    "merge_device_trace",
    "Watchdog", "default_watchdog", "set_default_watchdog", "watch_engine",
    "PHASES", "StepProfiler", "StepRecord", "step_metrics",
    "QuantileDigest", "SLODigest", "default_slo_digest",
    "set_default_slo_digest", "register_collect_hook",
    "unregister_collect_hook",
]


def enable() -> None:
    """Enable the default registry, the default flight recorder AND
    the default SLO digest. (Step profilers key off their registry's
    enabled flag, so this re-arms them too.)"""
    _enable_metrics()
    default_recorder().enable()
    default_slo_digest().enable()


def disable() -> None:
    """Disable the default registry, flight recorder and SLO digest
    (what ``PD_OBS_DISABLED=1`` does at import). Step profilers bound
    to the default registry go quiet with it."""
    _disable_metrics()
    default_recorder().disable()
    default_slo_digest().disable()


def serving_metrics(registry: Optional[Registry] = None) -> dict:
    """Create-or-get the serving metric families (idempotent).

    Shared by ``GenerationEngine``, ``ContinuousBatchingScheduler`` and
    ``PagedKVCache`` so each hot path binds its handles once at
    construction and never does a name lookup per step.
    """
    r = registry or default_registry()
    return {
        "ttft": r.histogram(
            "pd_serving_ttft_seconds",
            "time from submit to first generated token"),
        "decode_latency": r.histogram(
            "pd_serving_decode_latency_seconds",
            "wall time of one decode step (= per-token latency for "
            "every running request)"),
        "prefill_latency": r.histogram(
            "pd_serving_prefill_seconds",
            "wall time of one prefill step", ),
        "tokens": r.counter(
            "pd_serving_tokens_generated_total",
            "generated tokens across all requests"),
        "submitted": r.counter(
            "pd_serving_requests_submitted_total",
            "requests accepted by admission control"),
        "rejected": r.counter(
            "pd_serving_requests_rejected_total",
            "requests rejected by admission control (queue full)"),
        "finished": r.counter(
            "pd_serving_requests_finished_total",
            "requests that completed (EOS or max_new_tokens)"),
        "recycled": r.counter(
            "pd_serving_slot_recycles_total",
            "slots retired and returned to the free pool"),
        "backpressure": r.counter(
            "pd_serving_backpressure_total",
            "admissions deferred because the page pool could not "
            "reserve the request's worst-case footprint"),
        "queue_depth": r.gauge(
            "pd_serving_queue_depth", "requests waiting for a slot"),
        "running_slots": r.gauge(
            "pd_serving_running_slots", "slots actively decoding"),
        "pages_in_use": r.gauge(
            "pd_serving_kv_pages_in_use",
            "KV pages mapped by live slots (pool minus free minus "
            "evictable cached)"),
        "prefix_hits": r.counter(
            "pd_prefix_cache_hits_total",
            "full prompt pages served from the prefix cache instead of "
            "being re-prefilled"),
        "prefix_evictions": r.counter(
            "pd_prefix_cache_evictions_total",
            "cached refcount-0 pages reclaimed (LRU) for fresh "
            "allocations"),
        "prefix_shared_pages": r.gauge(
            "pd_prefix_shared_pages",
            "pages currently mapped read-only by two or more slots"),
        "prefix_cached_pages": r.gauge(
            "pd_prefix_cached_pages",
            "refcount-0 prefix-cache pages parked on the eviction LRU"),
        "spec_drafted": r.counter(
            "pd_spec_draft_tokens_total",
            "draft tokens proposed by the n-gram drafter and sent "
            "through a verify step"),
        "spec_accepted": r.counter(
            "pd_spec_accepted_tokens_total",
            "draft tokens accepted by verification (target-sampled "
            "token agreed with the draft)"),
        "spec_ratio": r.gauge(
            "pd_spec_acceptance_ratio",
            "cumulative accepted/drafted draft-token ratio (0 when "
            "nothing has been drafted yet)"),
        "preemptions": r.counter(
            "pd_preemptions_total",
            "running requests evicted from their slot by reason "
            "(pages/slot: a higher-priority admission needed the "
            "resources; manual: scheduler.preempt())",
            labelnames=("reason",)),
        "timeouts": r.counter(
            "pd_request_timeouts_total",
            "requests torn down because a TTFT or total deadline "
            "expired"),
        "cancels": r.counter(
            "pd_request_cancels_total",
            "requests torn down by an explicit cancel(rid)"),
        "swap_pages": r.counter(
            "pd_kv_swap_pages",
            "KV pages copied between the device pool and the "
            "host-memory swap tier, by direction (out = preemption "
            "eviction, in = restore on resume)",
            labelnames=("dir",)),
        "quota_deferrals": r.counter(
            "pd_tenant_quota_deferrals_total",
            "admission scans that skipped a waiting request because "
            "its tenant was at a page/slot quota"),
        "mixed_rows": r.counter(
            "pd_mixed_step_rows",
            "rows packed into unified mixed steps, by kind (chunk: a "
            "prefill-chunk slice; decode: one pending token; verify: a "
            "pending token + accepted-or-rejected draft block)",
            labelnames=("kind",)),
        "brownout_level": r.gauge(
            "pd_brownout_level",
            "current overload degradation-ladder level (0 = healthy; "
            "higher levels cumulatively shrink the step token budget, "
            "suspend speculation, pause prefix-cache admission and "
            "shed lowest-priority work)"),
        "shed": r.counter(
            "pd_shed_total",
            "requests shed by the brownout controller, by priority "
            "class (queued requests retired with finish_reason='shed' "
            "plus new submits rejected Overloaded — every one carries "
            "a computed retry-after)",
            labelnames=("priority",)),
        "device_faults": r.counter(
            "pd_device_faults_total",
            "requests terminated with finish_reason='device_fault', by "
            "kind (nan: non-finite sampled logits survived the lax "
            "retry; dispatch: the unified step dispatch raised and the "
            "lax retry raised too)",
            labelnames=("kind",)),
        "fault_retries": r.counter(
            "pd_device_fault_retries_total",
            "device-fault retries by kind (nan: rows whose logits read "
            "non-finite, their step run once more on the engine's own "
            "route at depth 0, quarantined at once at depth > 0; "
            "dispatch: steps whose injected dispatch fault was retried "
            "once)",
            labelnames=("kind",)),
        "journal_bytes": r.gauge(
            "pd_journal_bytes",
            "bytes currently held by the crash-safe request journal "
            "(drops on compaction; 0 when no journal is attached)"),
        "async_depth": r.gauge(
            "pd_async_depth",
            "async pipeline depth the engine runs at (0 = serial "
            "dispatch-and-commit; 1 = double buffer — step N+1 "
            "dispatches while N executes and N's results commit one "
            "step later)"),
        "async_rollbacks": r.counter(
            "pd_async_rollbacks_total",
            "in-flight rows rolled back because their request reached "
            "a terminal or preempted state before the dispatched step "
            "committed, by cause (finished/cancelled/timeout/preempted/"
            "device_fault) — the dropped tokens are regenerated "
            "bit-exactly on resume (per-(seed, token-index) sampling)",
            labelnames=("reason",)),
        "compiles": r.counter(
            "pd_xla_compiles_total",
            "step signatures launched for the first time by graph name "
            "(with CUDA graphs on: graph captures)",
            labelnames=("graph",)),
        "kv_quant_mode": r.gauge(
            "pd_kv_quant_mode",
            "KV-page storage mode the serving engine runs "
            "(0 = off/full-width, 1 = int8 codes + scale pool, "
            "2 = fp8/e4m3 codes + scale pool)"),
        "kv_page_bytes": r.gauge(
            "pd_kv_page_bytes",
            "bytes ONE KV page costs across all layers, K+V, scale "
            "rows included — the per-page cost the capacity-at-fixed-"
            "pool-bytes scaling of quantized serving divides by"),
    }


def ledger_metrics(registry: Optional[Registry] = None) -> dict:
    """Create-or-get the cost-ledger + compile-observatory + memory-
    observatory families (idempotent).

    Bound once by ``StepLedger`` (and ``PagedKVCache`` for the
    ``pd_kv_pages`` pool states) at construction; the byte/FLOP model
    behind the cost counters is :mod:`.ledger`'s.
    """
    r = registry or default_registry()
    return {
        "hbm_bytes": r.counter(
            "pd_cost_hbm_bytes_total",
            "modeled HBM bytes moved by dispatched steps, attributed "
            "per tenant (weight + KV page-walk + KV write + collective "
            "wire bytes; step-wide costs split by flat tokens with "
            "exact integer largest-remainder shares, so the tenant sum "
            "ALWAYS equals the engine total)",
            labelnames=("tenant",)),
        "model_flops": r.counter(
            "pd_cost_model_flops_total",
            "modeled model FLOPs of dispatched steps, attributed per "
            "tenant (matmul + attention FLOPs at the real ragged row "
            "lengths, not the padded bucket)",
            labelnames=("tenant",)),
        "bytes_component": r.counter(
            "pd_cost_bytes_component_total",
            "modeled HBM bytes by traffic component (weights: params "
            "streamed once per step; kv_read: page-walk bytes = pages "
            "touched x page_bytes, scale rows included; kv_write: "
            "freshly appended K/V rows; collective: per-device wire "
            "bytes of the step's psum/all-gather payloads)",
            labelnames=("component",)),
        "prefix_saved": r.counter(
            "pd_cost_prefix_bytes_saved_total",
            "modeled prefill HBM write bytes avoided by prefix-cache "
            "hits (pages served from cache x page_bytes)"),
        "compile_s": r.histogram(
            "pd_compile_seconds",
            "wall time of one CUDA graph capture (the eager warm-up "
            "step excluded) at the step-graph miss sites, by graph kind",
            labelnames=("graph",), buckets=log_buckets(1e-3, 600.0, 2.0)),
        "compile_peak_bytes": r.gauge(
            "pd_compile_peak_bytes",
            "peak device memory allocated while the most recently "
            "captured graph of each kind was captured "
            "(torch.cuda.max_memory_allocated; 0 off the card)",
            labelnames=("graph",)),
        "compile_cache": r.counter(
            "pd_compile_cache_total",
            "step-graph cache lookups by graph kind and outcome; the "
            "per-kind miss sum IS engine.xla_compiles, hits are "
            "dispatches of an already-launched step signature",
            labelnames=("graph", "event")),
        "compile_storms": r.counter(
            "pd_compile_storms_total",
            "recompile-storm warnings: a 'step' graph compile landed "
            "beyond the scheduler's bucket bound "
            "(len(step_buckets()) distinct graphs should cover steady "
            "state)"),
        "kv_pages": r.gauge(
            "pd_kv_pages",
            "KV pool pages by state (free/mapped/cached partition the "
            "usable device pool exactly, so their sum is always "
            "pd_kv_pool_pages; swapped counts host-tier swap entries "
            "held beyond the device pool)",
            labelnames=("state",)),
        "kv_pool_pages": r.gauge(
            "pd_kv_pool_pages",
            "usable device KV pages (num_pages minus the garbage "
            "page) — the invariant sum of the free/mapped/cached "
            "pd_kv_pages states"),
        "kv_pages_peak": r.gauge(
            "pd_kv_pages_peak",
            "high-water marks of the KV pool by state (mapped: most "
            "pages ever held by live slots; swapped: most host-tier "
            "swap entries ever held)",
            labelnames=("state",)),
        "kv_tenant_pages": r.gauge(
            "pd_kv_tenant_pages",
            "device KV pages currently resident per tenant (shared "
            "prefix pages count once per mapping)",
            labelnames=("tenant",)),
        "roofline_flops_per_s": r.gauge(
            "pd_roofline_flops_per_s",
            "achieved modeled FLOP/s per step bucket: ledger FLOPs of "
            "the latest fenced step divided by its fenced device span",
            labelnames=("bucket",)),
        "roofline_bytes_per_s": r.gauge(
            "pd_roofline_bytes_per_s",
            "achieved modeled HBM bytes/s per step bucket: ledger "
            "bytes of the latest fenced step divided by its fenced "
            "device span",
            labelnames=("bucket",)),
        "roofline_intensity": r.gauge(
            "pd_roofline_intensity",
            "arithmetic intensity (modeled FLOPs / modeled HBM bytes) "
            "of the latest fenced step per bucket — where the step "
            "sits on the roofline's x-axis",
            labelnames=("bucket",)),
        "kv_demoted": r.counter(
            "pd_kv_demoted_pages_total",
            "cold-prefix pages demoted to the host swap tier (LRU-"
            "parked prefix pages whose bytes spilled before the device "
            "page returned to the free list; a later prefix hit on "
            "demoted content faults the page back in at admission)"),
        "longest_kv": r.gauge(
            "pd_kv_longest_kv_len",
            "kv_len of the longest-context row in the most recently "
            "accounted step (0 until a step lands)"),
        "longest_split": r.gauge(
            "pd_kv_longest_row_split",
            "flash-decode KV-split factor of that longest row — how "
            "many partial-softmax chunks its page walk shards into "
            "(1 = unsplit)"),
        "kv_split_rows": r.counter(
            "pd_kv_split_rows_total",
            "dispatched step rows by flash-decode KV-split factor "
            "(ceil(row pages / PD_KV_SPLIT_PAGES); split=1 covers "
            "unsplit rows and the knob off — every accounted row "
            "lands in exactly one series)",
            labelnames=("split",)),
    }
