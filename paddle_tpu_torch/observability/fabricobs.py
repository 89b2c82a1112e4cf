"""Fabric-wide observability plane: cross-replica request tracing and
aggregated metrics for the replicated serving fabric.

Counterpart of ``paddle_tpu/observability/fabricobs.py``, host Python
only (no device work). A fabric's replicas each bind their own
recorder, registry and SLO digest at construction; this module joins
them, in three pieces:

- :class:`FabricTracer` — a trace context the fabric stamps at
  ``submit`` (trace id = submission sequence + the prompt's
  content-hash lineage, fully deterministic) and propagates through
  routing, prefill tickets, swap-entry handoff, migration redirects and
  respawn replays. Every rid a request ever wears maps to ONE trace id.
- :class:`ReplicaRecorder` — the recorder facade each replica is built
  under. It shares the base (fabric-level) ring wholesale, so every
  event still lands in one post-mortem buffer, but stamps
  ``(replica, trace, hop)`` attrs on the way in. ``merge_traces`` in
  :mod:`.chrome_trace` then renders ONE Perfetto track per request
  spanning replicas.
- :class:`FabricRegistryView` — a fabric-level :class:`Registry` that
  merges the per-replica registries at export time through
  ``register_collect_hook``: counters summed (respawn-proof via
  retired-slot accumulators), histograms merged bucket by bucket, every
  series re-exported with a ``replica`` label plus a ``replica="all"``
  aggregate row. SLO digests are not mirrored as gauges
  (quantile-of-quantiles is wrong); they are re-merged exactly
  (:func:`merge_slo_digests` re-observes the raw windows) and published
  fresh. A per-tenant cross-replica token/page table rides along as
  ``pd_fabric_tenant_*`` gauges.

Tracing disabled (``FabricConfig(trace=False)``) emits no trace events
and adds one branch per emit; the view does all merge work lazily at
scrape, never on the serving path.
"""
from __future__ import annotations

import hashlib
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .export import register_collect_hook, unregister_collect_hook
from .metrics import Registry
from .recorder import FlightRecorder
from .stepprof import SLODigest

__all__ = ["FabricTracer", "ReplicaRecorder", "FabricRegistryView",
           "merge_slo_digests"]


class FabricTracer:
    """Deterministic rid-lineage -> trace-id map.

    A trace id is minted once per fabric ``submit`` from the submission
    sequence number and the prompt's first content-hash block (falling
    back to a digest of the raw tokens for sub-page prompts) — no
    clocks, no randomness, so the same submission order yields the same
    ids run after run. Every subsequent rid the request wears (decode
    half of a disaggregated handoff, replayed rid after a kill,
    resubmitted ticket) is aliased onto the same trace, and each
    stamped event draws the trace's next monotonically increasing hop
    number — the order the relocation story is told in.

    ``begin``/``end`` bracket an engine call that will allocate a NEW
    rid (submit, restore): the first event the replica emits for an
    unbound rid inside the bracket auto-binds it to the pending trace,
    so even the rid's birth event ("queued") carries the trace context.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._seq = 0
        self._traces: Dict[int, str] = {}     # rid -> trace id
        self._hops: Dict[str, int] = {}       # trace id -> next hop
        self._pending: Optional[str] = None

    def new_trace(self, hashes: Sequence[bytes] = (),
                  prompt: Sequence[int] = ()) -> Optional[str]:
        if not self.enabled:
            return None
        if hashes:
            frag = bytes(hashes[0]).hex()[:8]
        else:
            frag = hashlib.sha1(
                repr(tuple(prompt)).encode()).hexdigest()[:8]
        tid = f"{self._seq:04d}-{frag}"
        self._seq += 1
        self._hops[tid] = 0
        return tid

    def bind(self, rid: Optional[int], tid: Optional[str]) -> None:
        if self.enabled and rid is not None and tid is not None:
            self._traces[rid] = tid

    def alias(self, new_rid: int, old_rid: int) -> Optional[str]:
        """The successor rid (handoff / migration / resubmit) inherits
        the predecessor's trace."""
        tid = self._traces.get(old_rid)
        if self.enabled and tid is not None:
            self._traces[new_rid] = tid
        return tid

    def trace_of(self, rid: Optional[int]) -> Optional[str]:
        return self._traces.get(rid) if rid is not None else None

    def next_hop(self, tid: str) -> int:
        h = self._hops.get(tid, 0)
        self._hops[tid] = h + 1
        return h

    def begin(self, tid: Optional[str]) -> None:
        self._pending = tid if self.enabled else None

    def end(self) -> None:
        self._pending = None

    def autobind(self, rid: int) -> Optional[str]:
        """Trace of ``rid``, binding it to the pending ``begin`` trace
        first if it has none yet (how a freshly allocated rid's very
        first recorder event gets stamped)."""
        tid = self._traces.get(rid)
        if tid is None and self._pending is not None:
            tid = self._traces[rid] = self._pending
        return tid


class ReplicaRecorder(FlightRecorder):
    """Recorder façade one fabric replica is constructed under.

    Shares the BASE recorder's ring (one bounded buffer for the whole
    fabric — ``default_recorder().by_category(...)`` still sees
    everything), but stamps each event with its replica index and,
    when the event's rid belongs to a known trace, the
    ``(trace, hop)`` pair that :func:`~.chrome_trace.merge_traces`
    groups by. With the tracer disabled the stamp is the ``replica``
    attr alone — zero trace attrs, zero trace events."""

    def __init__(self, base: FlightRecorder, replica: int,
                 tracer: Optional[FabricTracer] = None):
        # deliberately no super().__init__: the ring is SHARED — every
        # inherited query method (snapshot, by_category, ...) walks the
        # base's deque through self._buf
        while isinstance(base, ReplicaRecorder):
            base = base._base
        self._base = base
        self._buf = base._buf
        self._capacity = base.capacity
        self._replica = int(replica)
        self._tracer = tracer

    # enabled-ness always mirrors the base: obs.enable()/disable() on
    # the process default must keep governing replica emits
    @property
    def _enabled(self) -> bool:
        return self._base._enabled

    def enable(self) -> None:
        self._base.enable()

    def disable(self) -> None:
        self._base.disable()

    @property
    def replica(self) -> int:
        return self._replica

    def _stamp(self, rid: Optional[int], attrs: dict) -> dict:
        attrs.setdefault("replica", self._replica)
        t = self._tracer
        if t is not None and t.enabled and rid is not None:
            tid = t.autobind(rid)
            if tid is not None:
                attrs.setdefault("trace", tid)
                attrs.setdefault("hop", t.next_hop(tid))
        return attrs

    def emit(self, cat, name, rid=None, ts=None, dur=0.0, **attrs):
        if not self._base._enabled:
            return
        FlightRecorder.emit(self, cat, name, rid=rid, ts=ts, dur=dur,
                            **self._stamp(rid, attrs))

    def complete(self, cat, name, t0, rid=None, **attrs):
        if not self._base._enabled:
            return
        FlightRecorder.complete(self, cat, name, t0, rid=rid,
                                **self._stamp(rid, attrs))


def merge_slo_digests(digests: Sequence[SLODigest],
                      extra: Optional[Dict[Tuple[str, str, str],
                                           List[float]]] = None
                      ) -> SLODigest:
    """ONE digest whose windows are the concatenation of every input
    digest's raw windows (plus ``extra`` retired samples keyed the same
    way). Percentiles over the result equal numpy over the concatenated
    sample streams — the exact merge, where publishing each replica's
    quantiles and averaging them (quantile-of-quantiles) would not be.
    Capacity is sized to hold every sample, so nothing is evicted by
    the merge itself."""
    total = sum(len(qd) for d in digests for _, qd in d.items())
    if extra:
        total += sum(len(v) for v in extra.values())
    merged = SLODigest(capacity=max(4096, total))
    if extra:
        for (metric, tenant, prio), vals in sorted(extra.items()):
            for v in vals:
                merged.observe(metric, tenant, prio, v)
    for d in digests:
        for (metric, tenant, prio), qd in d.items():
            for v in qd.values():
                merged.observe(metric, tenant, prio, v)
    return merged


def _sum_hist_state(a: tuple, b: tuple) -> tuple:
    """Element-wise merge of two _HistogramChild.state() tuples (same
    bucket edges by construction — identical replicas)."""
    ab, asum, acount, amin, amax = a
    bb, bsum, bcount, bmin, bmax = b
    counts = [x + y for x, y in zip(ab, bb)]
    return (counts, asum + bsum, acount + bcount,
            min(amin, bmin), max(amax, bmax))


class FabricRegistryView:
    """Merged export-time view over N per-replica registries.

    Owns a fresh :class:`Registry` (``view.registry``) meant to back
    the fabric's ``/metrics`` endpoint. Registered as a global collect
    hook, it refreshes ONLY when its own registry is being exported
    (the hook is identity-guarded), mirroring every per-replica family
    with the label set extended by ``replica`` — counters by monotonic
    delta, gauges by set, histograms by whole-state copy — plus a
    ``replica="all"`` sum row for counters and histograms. Respawns
    stay monotonic: :meth:`retire_replica` folds a killed slot's final
    totals into per-slot accumulators before the fresh engine restarts
    from zero.

    ``pd_slo_*`` families are deliberately NOT mirrored: the exact
    cross-replica digest (:meth:`merged_slo`) is published into the
    view instead.

    Holds its fabric weakly so the global hook registration cannot keep
    dead fabrics (and their device pools) alive; a hook firing after
    the fabric is collected unregisters itself.
    """

    # instantaneous per-tenant accounting (tokens folds retired slots)
    _TENANT_GAUGES = (
        ("slots", "pd_fabric_tenant_slots",
         "running slots held per tenant per replica"),
        ("pages", "pd_fabric_tenant_pages",
         "KV pages held by running requests per tenant per replica"),
        ("tokens", "pd_fabric_tenant_tokens",
         "tokens generated per tenant per replica (killed slots' "
         "totals folded into the all row)"),
    )

    def __init__(self, fabric, alerts=None):
        self._fabric = weakref.ref(fabric)
        self._alerts = weakref.ref(alerts) if alerts is not None else None
        self.registry = Registry()
        self._retired_counters: Dict[tuple, float] = {}
        self._retired_hists: Dict[tuple, tuple] = {}
        self._retired_slo: Dict[Tuple[str, str, str], List[float]] = {}
        self._retired_tenant_tokens: Dict[str, int] = {}
        register_collect_hook(self._hook)

    def close(self) -> None:
        unregister_collect_hook(self._hook)

    def _hook(self, reg: Registry) -> None:
        if reg is not self.registry:
            return
        if self._fabric() is None:
            self.close()
            return
        self.refresh()

    # ----------------------------------------------------------- retire --
    def retire_replica(self, i: int) -> None:
        """Fold replica ``i``'s final cumulative state into the
        retired-slot accumulators. The fabric calls this from
        ``kill_replica`` BEFORE respawning the slot — the respawned
        engine restarts its registry from zero and the view's merged
        counters must not go backwards."""
        fab = self._fabric()
        if fab is None:
            return
        eng = fab.replicas[i]
        rep = str(i)
        for fam in eng.obs_registry.collect():
            if fam.name.startswith("pd_slo_"):
                continue
            for lv, child in fam.samples():
                key = (fam.name, lv, rep)
                if fam.kind == "counter":
                    self._retired_counters[key] = (
                        self._retired_counters.get(key, 0.0) + child.value)
                elif fam.kind == "histogram":
                    st = child.state()
                    prev = self._retired_hists.get(key)
                    self._retired_hists[key] = (
                        st if prev is None else _sum_hist_state(prev, st))
        for key, qd in eng.scheduler.slo_digest.items():
            vals = self._retired_slo.setdefault(key, [])
            vals.extend(qd.values())
            cap = eng.scheduler.slo_digest.capacity
            del vals[:-cap]
        for r in eng.scheduler.requests.values():
            # only FINISHED requests' tokens retire with the slot: a
            # live request replays onto a survivor with its output
            # intact, and folding it here would count it twice
            if r.state != "finished":
                continue
            self._retired_tenant_tokens[r.tenant] = (
                self._retired_tenant_tokens.get(r.tenant, 0)
                + len(r.output))

    # ------------------------------------------------------------ merge --
    def merged_slo(self) -> SLODigest:
        """The exact cross-replica SLO digest: every live replica's
        windows plus retired slots' samples, re-observed into one."""
        fab = self._fabric()
        if fab is None:
            return SLODigest()
        return merge_slo_digests(
            [eng.scheduler.slo_digest for eng in fab.replicas],
            extra=self._retired_slo)

    def tenant_table(self) -> Dict[str, dict]:
        """{tenant: {slots, pages, tokens, replicas: {i: row}}} summed
        across replicas (tokens include retired slots)."""
        fab = self._fabric()
        table: Dict[str, dict] = {}
        if fab is None:
            return table
        for i, eng in enumerate(fab.replicas):
            for tenant, row in eng.scheduler.tenant_usage().items():
                t = table.setdefault(tenant, {"slots": 0, "pages": 0,
                                              "tokens": 0, "replicas": {}})
                for k in ("slots", "pages", "tokens"):
                    t[k] += row[k]
                t["replicas"][str(i)] = dict(row)
        for tenant, tok in self._retired_tenant_tokens.items():
            t = table.setdefault(tenant, {"slots": 0, "pages": 0,
                                          "tokens": 0, "replicas": {}})
            t["tokens"] += tok
        return table

    def refresh(self) -> None:
        """Re-mirror every per-replica family into the view registry.
        Called by the collect hook at scrape; safe to call directly."""
        fab = self._fabric()
        if fab is None:
            return
        meta: Dict[str, tuple] = {}     # name -> (kind, help, labels, buckets)
        state: Dict[tuple, object] = {}  # (name, labelvalues, rep) -> value
        for i, eng in enumerate(fab.replicas):
            rep = str(i)
            for fam in eng.obs_registry.collect():
                if fam.name.startswith("pd_slo_"):
                    continue        # merged exactly below, never mirrored
                m = meta.setdefault(fam.name, (fam.kind, fam.help,
                                               fam.labelnames, fam.buckets))
                if m[0] != fam.kind or m[2] != fam.labelnames:
                    continue        # defensive: inconsistent twin family
                for lv, child in fam.samples():
                    key = (fam.name, lv, rep)
                    state[key] = (child.state()
                                  if fam.kind == "histogram"
                                  else child.value)
        # fold retired-slot accumulators (counters/histograms only)
        for key, v in self._retired_counters.items():
            if key[0] in meta:
                state[key] = state.get(key, 0.0) + v
        for key, st in self._retired_hists.items():
            if key[0] in meta:
                cur = state.get(key)
                state[key] = st if cur is None else _sum_hist_state(cur, st)
        # per-replica rows + the replica="all" aggregate
        agg: Dict[tuple, object] = {}
        for (name, lv, rep), val in sorted(state.items()):
            kind, help_, labelnames, buckets = meta[name]
            labels = labelnames + ("replica",)
            if kind == "counter":
                fam = self.registry.counter(name, help_, labels)
                child = fam.labels(*(lv + (rep,)))
                child.inc(max(0.0, float(val) - child.value))
                agg[(name, lv)] = agg.get((name, lv), 0.0) + float(val)
            elif kind == "gauge":
                fam = self.registry.gauge(name, help_, labels)
                fam.labels(*(lv + (rep,))).set(float(val))
            else:
                fam = self.registry.histogram(name, help_, labels,
                                              buckets or None)
                fam.labels(*(lv + (rep,))).load_state(*val)
                prev = agg.get((name, lv))
                agg[(name, lv)] = (val if prev is None
                                   else _sum_hist_state(prev, val))
        for (name, lv), val in sorted(agg.items()):
            kind, help_, labelnames, buckets = meta[name]
            labels = labelnames + ("replica",)
            if kind == "counter":
                fam = self.registry.counter(name, help_, labels)
                child = fam.labels(*(lv + ("all",)))
                child.inc(max(0.0, float(val) - child.value))
            else:
                fam = self.registry.histogram(name, help_, labels,
                                              buckets or None)
                fam.labels(*(lv + ("all",))).load_state(*val)
        # fabric-level families (router counters, hop histograms, the
        # replica-count gauge) live on the process registry the fabric
        # was built on — copied verbatim so the merged endpoint tells
        # the whole routing story without a second scrape
        freg = next(iter(fab._obs.values()))._registry
        for fam in freg.collect():
            if not fam.name.startswith("pd_fabric_"):
                continue
            for lv, child in fam.samples():
                if fam.kind == "counter":
                    vfam = self.registry.counter(fam.name, fam.help,
                                                 fam.labelnames)
                    vc = vfam.labels(*lv) if fam.labelnames \
                        else vfam._only()
                    vc.inc(max(0.0, child.value - vc.value))
                elif fam.kind == "gauge":
                    vfam = self.registry.gauge(fam.name, fam.help,
                                               fam.labelnames)
                    vc = vfam.labels(*lv) if fam.labelnames \
                        else vfam._only()
                    vc.set(child.value)
                else:
                    vfam = self.registry.histogram(
                        fam.name, fam.help, fam.labelnames,
                        fam.buckets or None)
                    vc = vfam.labels(*lv) if fam.labelnames \
                        else vfam._only()
                    vc.load_state(*child.state())
        # the exact merged digest, published fresh into the view
        self.merged_slo().publish(self.registry)
        # per-tenant cross-replica accounting table
        table = self.tenant_table()
        for field, gname, ghelp in self._TENANT_GAUGES:
            fam = self.registry.gauge(gname, ghelp,
                                      labelnames=("tenant", "replica"))
            for tenant, t in sorted(table.items()):
                fam.labels(tenant=tenant, replica="all").set(t[field])
                for rep, row in sorted(t["replicas"].items()):
                    fam.labels(tenant=tenant, replica=rep).set(row[field])
        alerts = self._alerts() if self._alerts is not None else None
        if alerts is not None:
            alerts.publish(self.registry)
