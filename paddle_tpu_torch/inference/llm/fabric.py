"""Replicated serving fabric: a prefix-affinity router over N engine
replicas behind ONE submit surface.

Counterpart of ``paddle_tpu/inference/llm/fabric.py``. One
:class:`~.engine.GenerationEngine` is one failure domain and one
throughput ceiling. The fabric runs N replicas in one process on the
one card (each with its OWN scheduler, KV pools, CUDA graphs and crash
journal, all sharing ONE copy of the model's weights) and exposes the
engine's ``submit``/``cancel``/``request_summary`` surface unchanged,
so a caller cannot tell whether one engine or N sit behind it:

- **Prefix-affine routing.** A prompt's full-page blocks are hashed
  with the same rolling content digest the prefix cache and swap tier
  key on (quant salt included), and the request is placed on the
  replica already holding the longest run of those pages (prefix cache
  or host swap tier), tie-broken by queue and page load. A replica more
  than ``spill`` queue entries above the least-loaded one loses its
  affinity claim (``spill=0`` never spills). A replica whose SLO budget
  burns (``observability.alerts``) is dropped from the candidates while
  a healthy one remains. Every routing input is deterministic.
- **Kill-invisible relocation.** Each replica journals its requests;
  ``kill_replica`` replays the victim's unfinished entries onto a
  survivor through ``engine.restore``, releases the victim's device
  memory (pools, graphs, pinned buffers: :meth:`GenerationEngine.close`)
  and respawns the slot. Sampling is a pure function of (seed, token
  index) and the fabric resolves every ``seed=None`` submit from its
  own RNG (the exact stream one engine would draw), so a relocated
  request's remaining tokens are those of the uninterrupted run: bit
  for bit on the plain path; on the card the replay re-prefills through
  the attention kernel's tile what the run had decoded through its
  one-query walk, which sums in another order, so a decision within
  that difference of a tie may part.
- **Prefill/decode disaggregation.** Under ``roles="disaggregated"``
  replica 0 runs prompts only (one-token tickets), publishes the
  finished KV pages into the shared content-addressed store as host
  (codes[, scales]) entries, and a decode replica imports them and
  admits the request as a prefix hit.

Knobs: ``policy.FABRIC_REPLICAS`` / ``FABRIC_SPILL`` / ``FABRIC_ROLES``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...observability import fabric_metrics
from ...observability.alerts import SLOAlerts
from ...observability.fabricobs import (FabricRegistryView, FabricTracer,
                                        ReplicaRecorder)
from ...observability.metrics import (Registry, default_registry,
                                      set_default_registry)
from ...observability.recorder import default_recorder, set_default_recorder
from ...observability.stepprof import (SLODigest, default_slo_digest,
                                       set_default_slo_digest)
from . import policy
from .engine import GenerationEngine, SamplingParams, resolve_sampling
from .faults import default_injector
from .journal import RequestJournal
from .quant import QuantConfig, prepare_model, resolve_quant
from .scheduler import (FINISHED, Overloaded, QueueFull, Request,
                        SchedulerConfig)

__all__ = ["FabricConfig", "ServingFabric", "ROUTE_REASONS"]

# the closed placement-reason set — every routed request is exactly one
ROUTE_REASONS = ("affinity", "load", "spill")


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Fabric topology; the defaults are the serving policy's knobs."""
    replicas: int = policy.FABRIC_REPLICAS
    spill: int = policy.FABRIC_SPILL        # affinity->load queue gap; 0 = never
    roles: str = policy.FABRIC_ROLES        # "colocated" | "disaggregated"
    journal_dir: Optional[str] = None       # None = fresh mkdtemp
    seed: int = 90210                       # seed-stream RNG (engine's value)
    trace: bool = True                      # cross-replica request tracing

    def __post_init__(self):
        object.__setattr__(self, "replicas", max(int(self.replicas), 1))
        object.__setattr__(self, "spill", max(int(self.spill), 0))
        roles = str(self.roles).strip().lower()
        if roles not in policy.FABRIC_ROLES_MODES or \
                (roles == "disaggregated" and self.replicas < 2):
            # unknown roles degrade to colocated, and disaggregation
            # needs at least one decode replica behind the prefill one
            roles = "colocated"
        object.__setattr__(self, "roles", roles)


class ServingFabric:
    """N same-process engine replicas behind one engine-shaped surface.

    Construction args past ``fabric_config`` are forwarded to every
    replica's :class:`GenerationEngine`: the replicas are identical by
    construction, which keeps their content-digest keyspaces (and so
    cross-replica page transfer) compatible. The quant config is
    resolved once here and the model prepared once for it (int8 weights,
    the int8 matmul's layout), so every replica serves the same weights
    on the card."""

    def __init__(self, model, fabric_config: Optional[FabricConfig] = None,
                 cache_config=None, scheduler_config=None,
                 eos_id: Optional[int] = None, attn_tier: str = "auto",
                 quant: Optional[QuantConfig] = None, device=None,
                 cuda_graphs: Optional[bool] = None):
        self.config = fabric_config or FabricConfig()
        sched = scheduler_config or SchedulerConfig()
        quant = resolve_quant(quant, sched)
        self._model = prepare_model(model, quant)
        self._cache_config = cache_config
        self._sched_config = sched
        self._eos_id = eos_id
        self._attn_tier = attn_tier
        # explicit even when all off: None would make each replica read
        # the scheduler config's knobs again
        self._quant = quant if quant is not None else QuantConfig()
        self._device = device
        self._cuda_graphs = cuda_graphs
        self._journal_dir = (self.config.journal_dir
                             or tempfile.mkdtemp(prefix="pd_fabric_"))
        n = self.config.replicas
        self.roles: List[str] = (["prefill"] + ["decode"] * (n - 1)
                                 if self.config.roles == "disaggregated"
                                 else ["colocated"] * n)
        self._gen = [0] * n                  # respawn generation per slot
        # cross-replica trace context + the fabric-level ring every
        # replica's stamped events land in — both must exist BEFORE the
        # replicas are spawned under their ReplicaRecorder facades
        self._rec = default_recorder()
        self._tracer = FabricTracer(enabled=self.config.trace)
        self.replicas: List[GenerationEngine] = [self._spawn(i)
                                                 for i in range(n)]
        # the fabric resolves seed=None submits itself, with the exact
        # stream a single engine would draw: seed assignment depends
        # only on submission order, never on routing — the bit-exact
        # anchor for relocation and disaggregation of sampled requests
        self._rng = np.random.default_rng(self.config.seed)
        self._faults = default_injector()
        self._where: Dict[int, int] = {}      # rid -> replica index
        self._redirect: Dict[int, int] = {}   # old rid -> successor rid
        self._orphans: Dict[int, Request] = {}       # finished, replica gone
        self._orphan_summaries: Dict[int, dict] = {}
        self._pending: Dict[int, dict] = {}   # prefill-ticket rid -> request
        self._handoff_retry: List[tuple] = []  # decode submits to retry
        self._store: "OrderedDict[bytes, tuple]" = OrderedDict()
        self.steps = 0
        self.migrations = 0
        self.handoff_pages = 0
        self._obs = fabric_metrics()
        # pre-bind every (replica, reason) series at 0: the families
        # must export before the first request is routed
        self._obs["replicas"].set(n)
        for i in range(n):
            for reason in ROUTE_REASONS:
                self._obs["routed"].labels(replica=str(i),
                                           reason=reason).inc(0)
        self._obs["hit_pages"].inc(0)
        self._obs["migrations"].inc(0)
        self._obs["handoff_pages"].inc(0)
        self._free0 = [e.cache.num_free_pages for e in self.replicas]
        # SLO burn-rate alerting (inert unless the SLO objectives are
        # set) + the merged metrics view backing the fabric's /metrics
        # (refreshes lazily at scrape via a collect hook)
        self.alerts = SLOAlerts(self)
        self.obs_view = FabricRegistryView(self, alerts=self.alerts)
        self._rec.emit("fabric", "created", replicas=n,
                       roles=self.config.roles)

    # ------------------------------------------------------- lifecycle --
    def _spawn(self, i: int) -> GenerationEngine:
        """A fresh replica in slot ``i`` with its own versioned journal
        (a respawn must never append to the corpse's file — restore
        reads the old one, the new engine writes a new one).

        The replica is constructed under ISOLATED observability
        defaults: its own registry and SLO digest (each replica's
        engine/scheduler/cache/stepprof bind these at construction —
        the fabric metrics view reads them back per replica and merges
        at export) and a :class:`ReplicaRecorder` facade over the
        fabric's ring (every event still lands in ONE post-mortem
        buffer, stamped ``(replica, trace, hop)``). The engine aligns the
        cache config to the fabric's quant config
        (``quant.align_cache_config``). The process defaults are
        restored before returning; the fabric's own families stay on
        the outer registry."""
        path = os.path.join(self._journal_dir,
                            f"replica{i}.g{self._gen[i]}.pdj")
        self._gen[i] += 1
        prev_reg = set_default_registry(
            Registry(enabled=default_registry().enabled))
        prev_slo = set_default_slo_digest(
            SLODigest(enabled=default_slo_digest().enabled))
        prev_rec = set_default_recorder(
            ReplicaRecorder(self._rec, i, self._tracer))
        try:
            return GenerationEngine(self._model,
                                    cache_config=self._cache_config,
                                    scheduler_config=self._sched_config,
                                    eos_id=self._eos_id,
                                    attn_tier=self._attn_tier,
                                    journal=RequestJournal(path),
                                    quant=self._quant, device=self._device,
                                    cuda_graphs=self._cuda_graphs)
        finally:
            set_default_registry(prev_reg)
            set_default_slo_digest(prev_slo)
            set_default_recorder(prev_rec)

    @property
    def eos_id(self):
        return self.replicas[0].eos_id

    def _decode_idxs(self) -> List[int]:
        return [i for i, r in enumerate(self.roles) if r != "prefill"]

    # --------------------------------------------------------- routing --
    def _route(self, hashes: Sequence[bytes],
               cands: Sequence[int]) -> tuple:
        """(replica index, reason, held pages) for a prompt's content
        digests among ``cands``. Affinity wins while the holder stays
        within ``spill`` queue entries of the least-loaded candidate;
        all inputs are deterministic, so so is the placement. A replica
        whose SLO budget is burning (alerts firing) is dropped from the
        candidate set while a healthy candidate remains — with alerting
        off (the default) ``burning`` is always empty and placement is
        bit-identical."""
        burning = self.alerts.burning
        if burning:
            ok = [i for i in cands if i not in burning]
            if ok and len(ok) < len(cands):
                cands = ok
        held = {i: self.replicas[i].cache.held_prefix_pages(hashes)
                for i in cands}
        loads = {i: self.replicas[i].scheduler.load_snapshot()
                 for i in cands}

        def loadkey(i: int):
            s = loads[i]
            return (s["queue_depth"] + s["running"], s["pages_in_use"], i)

        least = min(cands, key=loadkey)
        best = max(held.values())
        if best > 0:
            aff = min((i for i in cands if held[i] == best), key=loadkey)
            gap = (loads[aff]["queue_depth"] + loads[aff]["running"]
                   - loads[least]["queue_depth"] - loads[least]["running"])
            if self.config.spill > 0 and gap > self.config.spill:
                return least, "spill", held[least]
            return aff, "affinity", best
        return least, "load", 0

    def _count_routed(self, idx: int, reason: str, hit: int) -> None:
        self._obs["routed"].labels(replica=str(idx), reason=reason).inc()
        if hit:
            self._obs["hit_pages"].inc(hit)

    def _span(self, tid: Optional[str], name: str,
              t0: Optional[float] = None, hop: Optional[int] = None,
              **attrs) -> None:
        """One fabric-level hop on a request's trace: an instant (no
        ``t0``) or a completed slice since ``t0``. A slice that wraps
        an engine call passes the ``hop`` it drew at slice START, so
        hop order matches timestamp order even though the slice is
        emitted after the events it encloses. No-op when tracing is
        off (``tid`` is None)."""
        if tid is None:
            return
        if hop is None:
            hop = self._tracer.next_hop(tid)
        if t0 is None:
            self._rec.emit("trace", name, trace=tid, hop=hop, **attrs)
        else:
            now = time.perf_counter()
            self._rec.emit("trace", name, ts=t0, dur=now - t0,
                           trace=tid, hop=hop, **attrs)

    # ---------------------------------------------------------- submit --
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, tenant: str = "default",
               ttft_deadline_s: float = 0.0,
               deadline_s: float = 0.0) -> int:
        # validate BEFORE the seed draw (the engine's own rule): a
        # rejected submit must not shift later seed=None requests
        self.replicas[0].scheduler._validate_submit(
            prompt, max_new_tokens, priority, ttft_deadline_s, deadline_s)
        sp = resolve_sampling(sampling, self._rng)
        hashes = self.replicas[0].cache._block_hashes(prompt)
        tid = self._tracer.new_trace(hashes, prompt)
        self._span(tid, "submit", tenant=tenant, priority=priority)
        if self.roles[0] == "prefill":
            # disaggregated: a one-token ticket runs the prompt on the
            # prefill replica; the decode half is submitted at handoff
            self._tracer.begin(tid)
            try:
                rid = self.replicas[0].submit(
                    prompt, 1, sp, priority=priority, tenant=tenant,
                    ttft_deadline_s=ttft_deadline_s, deadline_s=deadline_s)
            finally:
                self._tracer.end()
            self._tracer.bind(rid, tid)
            self._where[rid] = 0
            if max_new_tokens > 1:
                self._pending[rid] = {
                    "prompt": list(prompt),
                    "max_new_tokens": int(max_new_tokens), "sp": sp,
                    "priority": priority, "tenant": tenant,
                    "ttft_deadline_s": ttft_deadline_s,
                    "deadline_s": deadline_s, "hashes": list(hashes)}
            self._rec.emit("fabric", "prefill_ticket", rid=rid,
                           pending=len(self._pending))
            return rid
        t0 = time.perf_counter()
        idx, reason, hit = self._route(hashes, list(range(len(self.replicas))))
        self._obs["route_s"].observe(time.perf_counter() - t0)
        self._span(tid, "route", t0=t0, replica=idx, reason=reason)
        self._tracer.begin(tid)
        try:
            rid = self.replicas[idx].submit(
                prompt, max_new_tokens, sp, priority=priority,
                tenant=tenant, ttft_deadline_s=ttft_deadline_s,
                deadline_s=deadline_s)
        finally:
            self._tracer.end()
        self._tracer.bind(rid, tid)
        self._where[rid] = idx
        self._count_routed(idx, reason, hit)
        self._rec.emit("fabric", "routed", rid=rid, replica=idx,
                       reason=reason, hit_pages=hit)
        return rid

    # -------------------------------------------- disaggregated handoff --
    def _submit_decode(self, ticket_rid: int, info: dict) -> None:
        t0 = time.perf_counter()
        tid = self._tracer.trace_of(ticket_rid)
        hop = self._tracer.next_hop(tid) if tid is not None else None
        idx, reason, _ = self._route(info["hashes"], self._decode_idxs())
        self._obs["route_s"].observe(time.perf_counter() - t0)
        deng = self.replicas[idx]
        entries = OrderedDict((k, self._store[k]) for k in info["hashes"]
                              if k in self._store)
        deng.cache.import_swap_entries(entries)
        hit = deng.cache.held_prefix_pages(info["hashes"])
        self._tracer.begin(tid)
        try:
            new = deng.submit(info["prompt"], info["max_new_tokens"],
                              info["sp"], priority=info["priority"],
                              tenant=info["tenant"],
                              ttft_deadline_s=info["ttft_deadline_s"],
                              deadline_s=info["deadline_s"])
        except (QueueFull, Overloaded):
            self._handoff_retry.append((ticket_rid, info))
            return
        finally:
            self._tracer.end()
        self._tracer.alias(new, ticket_rid)
        self._where[new] = idx
        self._redirect[ticket_rid] = new
        self._count_routed(idx, reason, hit)
        self._obs["handoff_s"].observe(time.perf_counter() - t0)
        self._span(tid, "handoff", t0=t0, hop=hop, replica=idx,
                   pages=hit)
        self._rec.emit("fabric", "handoff", rid=new, ticket=ticket_rid,
                       replica=idx, hit_pages=hit)

    def _service_handoffs(self) -> None:
        """Finished prefill tickets publish their KV pages into the
        shared store and spawn the decode half of the request."""
        for rid in list(self._pending):
            idx = self._where.get(rid, 0)
            eng = self.replicas[idx]
            req = eng.scheduler.requests.get(rid)
            if req is None:
                # the ticket vanished with a respawned replica and was
                # not replayed (defensive — restore remaps pending
                # tickets) — resubmit it afresh on the prefill slot
                info = self._pending.pop(rid)
                self._tracer.begin(self._tracer.trace_of(rid))
                try:
                    nrid = self.replicas[0].submit(
                        info["prompt"], 1, info["sp"],
                        priority=info["priority"], tenant=info["tenant"],
                        ttft_deadline_s=info["ttft_deadline_s"],
                        deadline_s=info["deadline_s"])
                finally:
                    self._tracer.end()
                self._tracer.alias(nrid, rid)
                self._where[nrid] = 0
                self._redirect[rid] = nrid
                self._pending[nrid] = info
                continue
            if req.state != FINISHED:
                continue
            info = self._pending.pop(rid)
            if req.finish_reason != "max_new_tokens":
                # cancelled / timeout / fault / EOS-at-first-token: the
                # ticket's terminal state IS the request's — determinism
                # means a decode replica would produce the same ending
                continue
            eng.cache.publish_prefix_pages(info["prompt"], info["hashes"])
            entries = eng.cache.export_swap_entries(info["hashes"])
            self._store.update(entries)
            if entries:
                self.handoff_pages += len(entries)
                self._obs["handoff_pages"].inc(len(entries))
            self._submit_decode(rid, info)

    def _retry_handoffs(self) -> None:
        retry, self._handoff_retry = self._handoff_retry, []
        for ticket_rid, info in retry:
            self._submit_decode(ticket_rid, info)

    # ------------------------------------------------------------ step --
    def step(self) -> str:
        """Step every replica once, then service disaggregation
        handoffs. Returns "idle" only when no replica, pending ticket
        or deferred handoff has work left."""
        if self._faults.should_kill_replica():
            victim = self._faults.config.replica_kill
            if 0 <= victim < len(self.replicas):
                self.kill_replica(victim)
        kinds = [eng.step() for eng in self.replicas]
        self.steps += 1
        self._service_handoffs()
        self._retry_handoffs()
        self.alerts.tick()
        if (all(k == "idle" for k in kinds) and not self._pending
                and not self._handoff_retry
                and not any(e.scheduler.has_work or e.pipeline_depth
                            for e in self.replicas)):
            return "idle"
        return "step"

    @property
    def has_work(self) -> bool:
        return (any(e.scheduler.has_work or e.pipeline_depth
                    for e in self.replicas)
                or bool(self._pending) or bool(self._handoff_retry))

    def run(self) -> None:
        while self.has_work:
            self.step()

    # ------------------------------------------------- kill / drain --
    def kill_replica(self, i: int, reason: str = "kill") -> int:
        """Kill replica ``i`` mid-flight: replay its unfinished
        requests bit-exactly onto survivors (prefill-role work replays
        on the respawn — only the prefill slot may prefill) and respawn
        the slot with fresh pools and a fresh journal. Finished
        requests are harvested first so their outputs stay addressable;
        the victim's pools, graphs and pinned buffers are released at
        the end. Returns requests migrated."""
        victim = self.replicas[i]
        entries = victim.journal.replay()
        for rid, req in victim.scheduler.requests.items():
            if req.state == FINISHED and rid not in self._orphans:
                self._orphans[rid] = req
                self._orphan_summaries[rid] = victim.request_summary(rid)
        self._rec.emit("fabric", "replica_killed", replica=i,
                       live=len(entries), reason=reason)
        # fold the dying slot's counters/digests into the view's
        # retired accumulators BEFORE the respawn swaps in a fresh
        # registry — merged counters must stay monotonic across kills
        self.obs_view.retire_replica(i)
        moved = 0
        targets = ([] if self.roles[i] == "prefill"
                   else [j for j in self._decode_idxs() if j != i])
        respawned = False
        if not targets:
            # prefill-role work (tickets included) can only replay on
            # the prefill slot, and a fabric with no other survivor
            # replays onto its own respawn — respawn first either way
            self.replicas[i] = self._spawn(i)
            respawned = True
            targets = [i]
        for rid in sorted(entries):
            t0 = time.perf_counter()
            tid = self._tracer.trace_of(rid)
            hop = self._tracer.next_hop(tid) if tid is not None else None
            idx, _, _ = (self._route(
                self.replicas[targets[0]].cache._block_hashes(
                    entries[rid].prompt), targets)
                if len(targets) > 1 else (targets[0], "load", 0))
            self._tracer.begin(tid)
            try:
                mapping = self.replicas[idx].restore({rid: entries[rid]})
            finally:
                self._tracer.end()
            new = mapping.get(rid)
            if new is None:
                continue
            self._tracer.alias(new, rid)
            self._where[new] = idx
            self._redirect[rid] = new
            if rid in self._pending:
                self._pending[new] = self._pending.pop(rid)
            moved += 1
            self.migrations += 1
            self._obs["migrations"].inc()
            self._obs["replay_s"].observe(time.perf_counter() - t0)
            self._span(tid, "migrate", t0=t0, hop=hop, replica=idx,
                       old_replica=i)
            self._rec.emit("fabric", "migrated", rid=new, old_rid=rid,
                           replica=idx)
        if not respawned:
            self.replicas[i] = self._spawn(i)
        # the victim's device memory goes now, not at a later collection
        victim.close()
        return moved

    def drain_replica(self, i: int) -> int:
        """Graceful version of :meth:`kill_replica`: drain the replica
        (journal flushed, residents preempted from committed state)
        before replaying its live requests elsewhere and respawning."""
        self.replicas[i].drain()
        return self.kill_replica(i, reason="drain")

    # -------------------------------------------------------- tracing --
    def _resolve(self, rid: int) -> int:
        while rid in self._redirect:
            rid = self._redirect[rid]
        return rid

    def find_request(self, rid: int) -> Optional[Request]:
        """The live Request object a fabric rid currently maps to,
        following migration/handoff redirects. None if unknown."""
        r = self._resolve(rid)
        if r in self._orphans:
            return self._orphans[r]
        idx = self._where.get(r)
        if idx is None:
            return None
        return self.replicas[idx].scheduler.requests.get(r)

    def replica_of(self, rid: int) -> Optional[int]:
        return self._where.get(self._resolve(rid))

    def output_of(self, rid: int) -> List[int]:
        r = self._resolve(rid)
        if r in self._orphans:
            return list(self._orphans[r].output)
        idx = self._where.get(r)
        if idx is None:
            raise KeyError(f"unknown request id {rid}")
        return self.replicas[idx].output_of(r)

    def request_summary(self, rid: int) -> dict:
        r = self._resolve(rid)
        if r in self._orphan_summaries:
            out = dict(self._orphan_summaries[r])
        else:
            idx = self._where.get(r)
            if idx is None:
                raise KeyError(f"unknown request id {rid}")
            out = self.replicas[idx].request_summary(r)
        out["fabric_rid"] = rid
        out["replica"] = self._where.get(r)
        out["migrated"] = rid != r
        return out

    def cancel(self, rid: int) -> bool:
        r = self._resolve(rid)
        if r in self._orphans:
            return False                       # already terminal
        self._pending.pop(r, None)             # decode half never spawns
        self._handoff_retry = [(t, info) for t, info in self._handoff_retry
                               if self._resolve(t) != r]
        idx = self._where.get(r)
        if idx is None:
            return False
        return self.replicas[idx].cancel(r)

    def live_rids(self) -> List[int]:
        """Rids currently waiting or running on any replica."""
        out: List[int] = []
        for eng in self.replicas:
            out.extend(req.rid for req in eng.scheduler.waiting)
            out.extend(req.rid for req in eng.scheduler.running.values())
        return sorted(out)

    # ----------------------------------------------------- invariants --
    def pool_restored(self) -> bool:
        """Every replica's free list back at its boot size — holds
        after a full drain even across kills/respawns (a fresh slot
        boots with the same pool)."""
        return all(e.cache.num_free_pages == f0
                   for e, f0 in zip(self.replicas, self._free0))

    def check_invariants(self) -> None:
        for eng in self.replicas:
            eng.cache.check_invariants()

    def summary(self) -> dict:
        return {"replicas": len(self.replicas),
                "roles": list(self.roles),
                "steps": self.steps,
                "migrations": self.migrations,
                "handoff_pages": self.handoff_pages,
                "pending_handoffs": len(self._pending),
                "store_entries": len(self._store),
                "load": [e.scheduler.load_snapshot()
                         for e in self.replicas]}
