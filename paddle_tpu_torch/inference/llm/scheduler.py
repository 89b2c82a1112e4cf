"""Continuous-batching scheduler (policy only — no device code).

Counterpart of ``paddle_tpu/inference/llm/scheduler.py`` for the
unified mixed-step plan. The scheduler owns WHAT runs each step; the
``GenerationEngine`` owns HOW it runs.

- **Admission control**: bounded waiting queues (``max_queue`` in
  all); ``submit`` raises ``QueueFull`` beyond it.
- **Backpressure**: a request is admitted to a slot only when the paged
  pool can reserve every page it may touch (prompt + max_new_tokens),
  so a running sequence never runs out of pages mid-decode.
- **Mixed steps**: each ``step_plan()`` is ONE ``mixed`` plan packing,
  into a single ragged dispatch, the prefill lane's next chunk row plus
  one decode row per running slot.
- **Chunked prefill** (``chunk_tokens > 0``) and the step token budget
  cap the chunk row; a prefix-cache hit starts prefill at
  ``cache.prefix_len(slot)``.
- **Shape buckets**: log-spaced ragged-token buckets, so the flat step
  layout equals the JAX engine's.
- **Slot recycling**: EOS or ``max_new_tokens`` retires the slot and
  returns its pages.
- **Speculative decoding** (``spec_tokens > 0``): a decode row may carry
  the engine's n-gram drafts, a wider row of the same step;
  ``on_verify_done`` lands a variable number of tokens per slot. The
  adaptive draft state lives on the ``Request`` (``spec_len``,
  ``spec_window``, ``spec_idle``) and the totals in ``stats``.

- **Priority classes and tenant quotas**: every request carries a
  ``priority`` (0 = most urgent, ``priority_classes`` classes) and a
  ``tenant``. Admission scans the classes in order, FIFO within one; a
  tenant at its slot or page quota (``tenant_max_slots`` /
  ``tenant_max_pages``, over running requests) is skipped and never
  blocks another tenant. One class and no quotas is the plain FIFO.
- **Deadlines and cancellation**: per-request TTFT and total deadlines
  are swept before every plan (``sweep_deadlines``); an expired or
  cancelled request is torn down at any stage with its pages restored
  (``finish_reason`` ``timeout`` / ``cancelled``), and reaches its
  terminal state exactly once.
- **Preemption with KV swap**: a higher-priority request blocked on a
  slot or pages evicts the lowest-priority running ones (most recently
  admitted first). A victim's full resident pages are registered in
  the prefix cache and copied to the host swap tier
  (``PagedKVCache.swap_out``), its slot is released, and it re-queues
  at the front of its class; on re-admission the pages are mapped or
  written back (``swap_in``) and only the tail re-prefills. Sampling is
  a pure function of (seed, token index), so the resumed request
  delivers the same tokens. A victim that cannot re-queue ends with
  ``finish_reason="preempted"``.
- **Async pipelining hooks** (engine-attached): ``async_hold`` lists
  the slots the next plan skips, and ``teardown_hook(req, slot,
  cause)`` runs at the top of every slot teardown so the engine can
  dead-mark the request's rows still in flight.
- **Resilience hooks**: ``admission_paused`` (``engine.drain``),
  ``spec_suspended``, ``step_budget_override`` and ``shed_floor`` (the
  brownout controller's levels), ``shed_queued`` and ``Overloaded``
  with its retry-after, ``fault_terminate`` (the device-fault
  quarantine), the fault injector's allocator exhaustion in the
  admission scan, and the optional request ``journal`` fed from
  ``_emit`` and ``_retire``.
- **Observability**: the serving counters and gauges, flight-recorder
  events of every lifecycle transition, and the SLO digest's queue
  wait, TTFT and inter-token latency per {tenant, priority}.
- **Request ids** come from a per-scheduler block of ``RID_BLOCK``
  ids, unique across every engine in the process, so the flight
  recorder's per-request tracks and a journal restore never mix two
  engines' requests.

Quantized collectives are a later slice of the port: the knob exists so
a config reads like the JAX one, and a non-default value raises
``NotImplementedError`` naming the slice. ``load_snapshot`` is the
serving fabric router's load probe.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from ...observability import serving_metrics
from ...observability.recorder import (DECODE_PROGRESS_EVERY,
                                       default_recorder)
from ...observability.stepprof import default_slo_digest
from . import policy
from .faults import default_injector
from .kv_cache import PagedKVCache

__all__ = ["SchedulerConfig", "Request", "QueueFull", "InvalidRequest",
           "Overloaded", "ContinuousBatchingScheduler", "Plan", "RowPlan",
           "prefill_buckets", "ragged_buckets"]

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", \
    "finished"
PREEMPTED = "preempted"


class QueueFull(RuntimeError):
    """Admission control rejected the request (queue depth exceeded)."""


class Overloaded(QueueFull):
    """Typed brownout rejection: the engine is shedding this request's
    priority class under sustained overload. ``retry_after_s`` is the
    controller-computed backoff hint (always > 0). A :class:`QueueFull`,
    so callers that treat rejection as backpressure keep working."""

    def __init__(self, retry_after_s: float, msg: Optional[str] = None):
        super().__init__(
            msg or f"engine overloaded — retry after {retry_after_s:.3f}s")
        self.retry_after_s = float(retry_after_s)


class InvalidRequest(ValueError):
    """Typed rejection of a malformed submit (empty prompt, non-positive
    ``max_new_tokens``, a prompt that cannot fit the engine, pool or
    tenant quota, a priority outside the classes, a negative deadline),
    raised before a rid is assigned."""


# each scheduler draws its request ids from its own block, so rids are
# unique across every engine in the process; a scheduler that outlives
# its block chains a fresh one
RID_BLOCK = 1 << 20
_rid_blocks = itertools.count()

# per-token delivery timestamps kept on each Request (bounded ring): the
# raw material of request_summary's inter-token-latency percentiles
ITL_RING = max(2, int(os.environ.get("PD_OBS_ITL_RING", "256")))


def _later_slice(knob: str, value, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} needs the {slice_name} slice of the PyTorch "
        "port, which is not ported yet")


def prefill_buckets(min_bucket: int, max_seq_len: int) -> List[int]:
    """Log-spaced prompt-length buckets: min_bucket, 2*min_bucket, ...
    up to (and including) max_seq_len."""
    buckets = []
    b = max(min_bucket, 1)
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return buckets


def ragged_buckets(min_bucket: int, max_ragged_tokens: int) -> List[int]:
    """Log-spaced TOTAL-ragged-token buckets of the unified mixed step:
    min_bucket, 2*min_bucket, ... up to (and including) the most tokens
    one step can pack."""
    return prefill_buckets(min_bucket, max_ragged_tokens)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_slots: int = 8
    max_queue: int = policy.MAX_QUEUE
    min_bucket: int = 16
    max_seq_len: int = 512
    # chunked prefill: token budget of one prefill chunk (0 = off)
    chunk_tokens: int = policy.DEFAULT_CHUNK_TOKENS
    # ragged tokens packed per mixed step (0 = unbounded)
    step_token_budget: int = policy.STEP_TOKEN_BUDGET
    # speculative decoding: most draft tokens per decode row (0 = off)
    spec_tokens: int = policy.DEFAULT_SPEC_TOKENS
    # multi-tenant admission: priority classes (0 most urgent; a submit
    # outside [0, classes) is InvalidRequest), per-tenant quotas over
    # running requests (0 = unlimited), and SLO preemption (False: a
    # blocked high-priority admission waits)
    priority_classes: int = policy.PRIORITY_CLASSES
    tenant_max_pages: int = policy.TENANT_MAX_PAGES
    tenant_max_slots: int = policy.TENANT_MAX_SLOTS
    preempt: bool = True
    # async pipelining: steps dispatched ahead of their commit (0 =
    # serial); the engine reads it
    async_depth: int = policy.ASYNC_DEPTH
    # overload brownout: depth of the degradation ladder the engine's
    # controller may walk (0 = controller off; see brownout.py)
    brownout_levels: int = policy.BROWNOUT_LEVELS
    # quantized serving: KV-page storage mode (off | int8 | fp8), weight
    # storage mode (off | int8) and the int8 x int8 weight matmul (off |
    # int8). The scheduler never reads them (page accounting is
    # encoding-agnostic); an engine built without an explicit
    # QuantConfig does.
    kv_quant: str = policy.KV_QUANT
    weight_quant: str = policy.WEIGHT_QUANT
    weight_matmul: str = policy.WEIGHT_MATMUL
    # a later slice (quantized mesh collectives): only "off" is accepted
    coll_quant: str = "off"
    # flash-decode KV split: chunk width in pages of the attention
    # kernels' split page walk (0 = off). A kernel schedule knob the
    # engine reads; the scheduler never does.
    kv_split_pages: int = policy.KV_SPLIT_PAGES

    def __post_init__(self):
        if self.coll_quant != "off":
            raise _later_slice("coll_quant", self.coll_quant,
                               "tensor-parallel mesh (ROADMAP A.11)")

    def max_step_tokens(self) -> int:
        """Most ragged tokens one mixed step can pack: the chunk row's
        cap (chunk budget, else a whole max_seq_len context; the step
        budget caps either) plus one 1 + drafts row per slot."""
        chunk_cap = (self.chunk_tokens if self.chunk_tokens > 0
                     else self.max_seq_len)
        if self.step_token_budget > 0:
            chunk_cap = min(chunk_cap, self.step_token_budget)
        return chunk_cap + self.max_slots * (1 + max(self.spec_tokens, 0))

    def step_buckets(self) -> List[int]:
        return ragged_buckets(self.min_bucket, self.max_step_tokens())


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: object = None        # engine-interpreted SamplingParams
    state: str = WAITING
    slot: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""        # eos | max_new_tokens | timeout |
                                   # cancelled | preempted | shed |
                                   # device_fault
    prefill_pos: int = 0           # prompt tokens whose KV is resident
    prefill_chunks: int = 0        # chunk rows issued for this request
    # memoized full-page rolling digests of the prompt
    block_hashes: Optional[List[bytes]] = None
    # speculative decoding (engine-maintained): the current adaptive
    # draft budget (starts at spec_tokens, decays to 0 = plain decode
    # and probes back), lifetime drafted/accepted tokens, the recent
    # (drafted, accepted) window and draftless steps toward a probe
    spec_len: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_window: List = dataclasses.field(default_factory=list)
    spec_idle: int = 0
    # multi-tenant serving: priority class (0 most urgent), tenant,
    # deadlines in seconds from submit (0 = none), and the lifecycle
    # timeline (perf_counter seconds; 0.0 = not reached)
    priority: int = 0
    tenant: str = "default"
    ttft_deadline_s: float = 0.0   # to the first token
    deadline_s: float = 0.0        # to the terminal state
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    pages_reserved: int = 0
    prefix_len: int = 0            # tokens served from cache or swap
    preemptions: int = 0           # times evicted from a slot
    t_preempt: float = 0.0         # the latest eviction
    restored_tokens: int = 0       # served from cache/swap at the latest
                                   # re-admission of a preempted request
    t_prefill_start: float = 0.0   # the first chunk row's staging
    # inter-token latency: the newest token's delivery time and a
    # bounded ring of the last ITL_RING delivery times
    t_last_token: float = 0.0
    token_times: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=ITL_RING))
    # the backoff hint attached when the request was shed (0.0 else)
    retry_after_s: float = 0.0
    # the cost ledger's modelled bytes and FLOPs of every step the
    # request rode in (0 with the ledger off)
    cost_hbm_bytes: int = 0
    cost_flops: int = 0

    def kv_tokens(self) -> List[int]:
        """prompt + generated output — every token whose KV must be
        resident before the request can take another decode step (what
        a preempted request re-prefills on resume)."""
        return self.prompt + self.output if self.output else self.prompt


@dataclasses.dataclass
class RowPlan:
    """One ROW of a mixed step: ``kind`` 'chunk' (a prefill-chunk slice
    of one request — ``start``/``chunk_len`` span its context) or
    'decode' (one pending token of a running request)."""
    kind: str
    request: Request
    start: int = 0
    chunk_len: int = 0
    first_chunk: bool = False
    final_chunk: bool = False


@dataclasses.dataclass
class Plan:
    """One engine step: ``kind`` 'mixed' with ``rows`` packed into one
    ragged dispatch, or 'idle'."""
    kind: str
    rows: List[RowPlan] = dataclasses.field(default_factory=list)


class ContinuousBatchingScheduler:
    def __init__(self, cache: PagedKVCache, config: SchedulerConfig):
        if config.max_slots > cache.config.max_slots:
            raise ValueError("scheduler max_slots exceeds cache max_slots")
        if config.max_seq_len > cache.config.max_seq_len:
            raise ValueError(
                f"scheduler max_seq_len={config.max_seq_len} exceeds the "
                f"cache's page-table reach ({cache.config.max_seq_len})")
        self.cache = cache
        self.config = config
        self._step_buckets = config.step_buckets()
        # one FIFO per priority class, class 0 scanned first
        self._queues: List[Deque[Request]] = [
            deque() for _ in range(max(config.priority_classes, 1))]
        self.running: Dict[int, Request] = {}      # slot -> request
        self.finished: Dict[int, Request] = {}     # rid -> request
        self.requests: Dict[int, Request] = {}     # rid -> request
        # the newest finished rids (a bounded view for watchdog dumps)
        self.recent_finished: Deque[int] = deque(maxlen=64)
        self._free_slots = list(range(config.max_slots - 1, -1, -1))
        self._chunking: Optional[Request] = None   # owner of the prefill lane
        self.rid_base = next(_rid_blocks) * RID_BLOCK
        self._next_rid = self.rid_base
        self._rid_block_end = self.rid_base + RID_BLOCK
        # lifecycle counts, and the speculative-decoding totals (engine-
        # updated): verify steps, slot participations in them, drafted /
        # accepted / emitted tokens
        self.stats = {"n_submitted": 0, "n_rejected": 0, "n_prefills": 0,
                      "n_chunks": 0, "n_decode_steps": 0,
                      "n_backpressure": 0, "n_recycled": 0,
                      "n_finished": 0,
                      "n_spec_steps": 0, "n_spec_slot_steps": 0,
                      "n_spec_drafted": 0, "n_spec_accepted": 0,
                      "n_spec_emitted": 0,
                      "n_preemptions": 0, "n_resumed": 0,
                      "n_preempt_drops": 0, "n_timeouts": 0,
                      "n_cancelled": 0, "n_quota_deferred": 0,
                      "n_shed": 0, "n_overload_rejected": 0,
                      "n_device_faults": 0}
        # registry handles bound once; the labelled families' known
        # series pre-bound so an export shows them at zero
        self._obs = serving_metrics()
        for _reason in ("slot", "pages", "manual"):
            self._obs["preemptions"].labels(reason=_reason)
        for _pr in range(max(config.priority_classes, 1)):
            self._obs["shed"].labels(priority=str(_pr))
        for _kind in ("nan", "dispatch"):
            self._obs["device_faults"].labels(kind=_kind)
        # exact SLO percentiles keyed {tenant, priority}: queue wait,
        # TTFT, inter-token latency
        self._slo = default_slo_digest()
        self._rec = default_recorder()
        self._faults = default_injector()
        self._last_bp_rid = -1     # one backpressure event per blocked head
        self._quota_evented: set = set()   # one quota event per deferral
        # live requests carrying a deadline: the sweep is skipped while
        # this is zero
        self._live_deadlines = 0
        # ---- resilience hooks (brownout controller / journal / drain) --
        # admission_paused: engine.drain() stops the admission scan;
        # spec_suspended: brownout level >= 2 turns drafting off
        # (lossless: tokens never change); step_budget_override: the
        # brownout's shrunk ragged-token budget (None = config value);
        # shed_floor: priority classes >= this are rejected Overloaded
        # at submit with overload_retry_after_s (None = accept all)
        self.admission_paused = False
        self.spec_suspended = False
        self.step_budget_override: Optional[int] = None
        self.shed_floor: Optional[int] = None
        self.overload_retry_after_s = 0.0
        # optional crash-safe journal (engine-attached): _emit appends
        # delivered tokens, _retire terminal reasons
        self.journal = None
        # async pipelining (engine-attached): slots the next plan skips
        # while their in-flight results cannot be planned past, and the
        # hook every slot teardown calls first, teardown_hook(req, slot,
        # cause), so the engine can dead-mark the request's rows still
        # in flight
        self.async_hold: set = set()
        self.teardown_hook = None

    # -------------------------------------------------------------- views --
    @property
    def waiting(self) -> List[Request]:
        """Waiting requests in admission-scan order (class 0 first, FIFO
        within a class); a snapshot."""
        return [r for q in self._queues for r in q]

    @property
    def num_waiting(self) -> int:
        return sum(len(q) for q in self._queues)

    def load_snapshot(self) -> Dict[str, int]:
        """Instantaneous load facts the serving fabric's router ties
        affinity against: queued and running request counts and KV-page
        pressure. Pure reads: safe to probe every replica on every
        submit."""
        return {"queue_depth": self.num_waiting,
                "running": len(self.running),
                "pages_in_use": self.cache.pages_in_use,
                "free_pages": self.cache.num_free_pages}

    @property
    def slo_digest(self):
        """The SLO digest this scheduler observes into."""
        return self._slo

    # --------------------------------------------------------- admission --
    def _validate_submit(self, prompt, max_new_tokens, priority=0,
                         ttft_deadline_s=0.0, deadline_s=0.0) -> None:
        """Typed rejection of malformed submits, before a rid is drawn."""
        if len(prompt) == 0:
            raise InvalidRequest("prompt must not be empty")
        if max_new_tokens < 1:
            raise InvalidRequest(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.config.max_seq_len:
            raise InvalidRequest(
                f"prompt+max_new_tokens ({len(prompt)}+{max_new_tokens}) "
                f"exceeds max_seq_len={self.config.max_seq_len}")
        need = self.cache.config.pages_for(len(prompt) + max_new_tokens)
        if need > self.cache.slot_page_capacity:
            raise InvalidRequest(
                f"request needs {need} pages but one slot maps at most "
                f"{self.cache.slot_page_capacity} — it could never be "
                "admitted; grow CacheConfig.num_pages / max_seq_len")
        if (self.config.tenant_max_pages > 0
                and need > self.config.tenant_max_pages):
            raise InvalidRequest(
                f"request needs {need} pages but the per-tenant quota is "
                f"{self.config.tenant_max_pages} — it could never be "
                "admitted")
        if not 0 <= priority < self.config.priority_classes:
            raise InvalidRequest(
                f"priority {priority} outside [0, "
                f"{self.config.priority_classes})")
        if ttft_deadline_s < 0 or deadline_s < 0:
            raise InvalidRequest("deadlines must be >= 0 seconds")

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               sampling=None, priority: int = 0, tenant: str = "default",
               ttft_deadline_s: float = 0.0, deadline_s: float = 0.0) -> int:
        self._validate_submit(prompt, max_new_tokens, priority,
                              ttft_deadline_s, deadline_s)
        if self.admission_paused:
            # draining: a submit accepted now would never be served
            self.stats["n_rejected"] += 1
            self._obs["rejected"].inc()
            raise QueueFull("engine draining — admission closed")
        if self.shed_floor is not None and priority >= self.shed_floor:
            # brownout shedding: typed rejection before a rid exists,
            # with the controller's backoff hint
            retry = max(self.overload_retry_after_s, 1e-3)
            self.stats["n_overload_rejected"] += 1
            self._obs["shed"].labels(priority=str(priority)).inc()
            self._rec.emit("request", "shed", priority=priority,
                           retry_after_s=retry, stage="submit",
                           queue_depth=self.num_waiting)
            raise Overloaded(retry, f"brownout shedding priority classes "
                                    f">= {self.shed_floor} — retry after "
                                    f"{retry:.3f}s")
        if self.num_waiting >= self.config.max_queue:
            self.stats["n_rejected"] += 1
            self._obs["rejected"].inc()
            self._rec.emit("request", "rejected",
                           queue_depth=self.num_waiting,
                           prompt_len=len(prompt))
            raise QueueFull(
                f"serving queue full ({self.config.max_queue} pending)")
        if self._next_rid >= self._rid_block_end:
            self._next_rid = next(_rid_blocks) * RID_BLOCK
            self._rid_block_end = self._next_rid + RID_BLOCK
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, sampling=sampling,
                      spec_len=self.config.spec_tokens, priority=priority,
                      tenant=tenant or "default",
                      ttft_deadline_s=float(ttft_deadline_s),
                      deadline_s=float(deadline_s),
                      t_submit=time.perf_counter())
        self._queues[priority].append(req)
        self.requests[rid] = req
        if req.ttft_deadline_s > 0 or req.deadline_s > 0:
            self._live_deadlines += 1
        self.stats["n_submitted"] += 1
        self._obs["submitted"].inc()
        self._obs["queue_depth"].set(self.num_waiting)
        self._rec.emit("request", "queued", rid=rid, ts=req.t_submit,
                       prompt_len=len(prompt),
                       max_new_tokens=max_new_tokens,
                       priority=priority, tenant=req.tenant,
                       queue_depth=self.num_waiting)
        return rid

    def effective_step_budget(self) -> int:
        """The ragged-token budget of one mixed step: the brownout
        controller's shrunk override when a level is active, else the
        configured ``step_token_budget`` (0 = unbounded). The buckets
        are sized from the config value, so an override only shrinks a
        step, never adds a signature."""
        if self.step_budget_override is not None:
            return self.step_budget_override
        return self.config.step_token_budget

    def ragged_bucket_for(self, n: int) -> int:
        """Smallest ragged-token bucket holding an ``n``-token step."""
        for b in self._step_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} ragged tokens exceed the max step bucket "
                         f"{self._step_buckets[-1]}")

    # ---------------------------------------------------------- planning --
    def _hashes_for(self, req: Request) -> List[bytes]:
        """Memoized rolling digests over ``req.kv_tokens()`` (preemption
        drops the memo: the context grew by the output)."""
        if req.block_hashes is None:
            c = self.cache.config
            req.block_hashes = (self.cache._block_hashes(req.kv_tokens())
                                if c.prefix_cache or c.swap_pages > 0
                                else [])
        return req.block_hashes

    def _need_tokens(self, req: Request) -> int:
        # the reserve-ahead bound; output counts inside max_new_tokens,
        # so it also covers a resumed request's context and the rest
        return len(req.prompt) + req.max_new_tokens

    def _pages_ok(self, req: Request) -> bool:
        return self.cache.can_allocate(self._need_tokens(req),
                                       prompt=req.kv_tokens(),
                                       hashes=self._hashes_for(req))

    def tenant_usage(self) -> Dict[str, Dict[str, int]]:
        """Per tenant: slots and KV pages held by running requests, and
        tokens generated so far by every request this scheduler
        remembers."""
        out: Dict[str, Dict[str, int]] = {}
        for tenant, (slots, pages) in self._tenant_usage().items():
            out[tenant] = {"slots": slots, "pages": pages, "tokens": 0}
        for r in self.requests.values():
            row = out.setdefault(r.tenant,
                                 {"slots": 0, "pages": 0, "tokens": 0})
            row["tokens"] += len(r.output)
        return out

    def _tenant_usage(self) -> Dict[str, List[int]]:
        """tenant -> [held slots, held pages] over running requests, once
        per admission scan."""
        usage: Dict[str, List[int]] = {}
        for r in self.running.values():
            held = usage.setdefault(r.tenant, [0, 0])
            held[0] += 1
            held[1] += r.pages_reserved
        return usage

    def _quota_blocked(self, req: Request,
                       usage: Dict[str, List[int]]) -> bool:
        """True when admitting ``req`` now would push its tenant over a
        slot or page quota; the scan then skips it."""
        cfg = self.config
        held_slots, held_pages = usage.get(req.tenant, (0, 0))
        if cfg.tenant_max_slots > 0 and held_slots + 1 > cfg.tenant_max_slots:
            blocked = True
        elif cfg.tenant_max_pages > 0:
            need = self.cache.config.pages_for(self._need_tokens(req))
            blocked = held_pages + need > cfg.tenant_max_pages
        else:
            blocked = False
        if blocked:
            self.stats["n_quota_deferred"] += 1
            self._obs["quota_deferrals"].inc()
            if req.rid not in self._quota_evented:  # one event per deferral
                self._quota_evented.add(req.rid)
                self._rec.emit("request", "quota_deferred", rid=req.rid,
                               tenant=req.tenant)
        return blocked

    def _note_backpressure(self, req: Request) -> None:
        self.stats["n_backpressure"] += 1
        self._obs["backpressure"].inc()
        if req.rid != self._last_bp_rid:   # one event per blocked head
            self._last_bp_rid = req.rid
            self._rec.emit(
                "request", "backpressure", rid=req.rid,
                need_pages=self.cache.config.pages_for(
                    self._need_tokens(req)),
                free_pages=self.cache.num_free_pages)

    def _admission_candidate(self, allow_preempt: bool = True
                             ) -> Optional[Request]:
        """Scan the classes in priority order, FIFO within a class.
        Quota-blocked requests are skipped; the first request blocked
        on a slot or pages ends the scan, after a preemption attempt, so
        nothing later or of lower priority starves it."""
        if self.num_waiting == 0 or self.admission_paused:
            return None
        # injected allocator exhaustion: this scan sees a full pool
        fault_block = self._faults.alloc_fail()
        quotas_on = (self.config.tenant_max_slots > 0
                     or self.config.tenant_max_pages > 0)
        usage = self._tenant_usage() if quotas_on else None
        for q in self._queues:
            for req in q:
                if quotas_on and self._quota_blocked(req, usage):
                    continue
                if (self._free_slots and not fault_block
                        and self._pages_ok(req)):
                    return req
                if allow_preempt and self._try_preempt_for(req):
                    return req
                self._note_backpressure(req)
                return None
        return None

    def _try_preempt_for(self, cand: Request) -> bool:
        """Evict running requests of a strictly lower priority (the
        largest class first, the most recently admitted first) until
        ``cand`` has a slot and pages, or no victim is left. Returns
        whether ``cand`` is now admissible."""
        if not self.config.preempt:
            return False
        victims = [r for r in self.running.values()
                   if r.priority > cand.priority
                   and r.state in (PREFILL, RUNNING)]
        if not victims:
            return False
        # optimistic precheck (a prefix hit only shrinks the need): evict
        # no one for a candidate that still could not fit
        need = self.cache.config.pages_for(self._need_tokens(cand))
        reclaimable = sum(len(self.cache._allocated_pages[v.slot])
                          for v in victims)
        if self.cache.num_free_pages + reclaimable < need:
            return False
        victims.sort(key=lambda r: (-r.priority, -r.t_admit))
        for v in victims:
            if self._free_slots and self._pages_ok(cand):
                break
            self.preempt_request(
                v, reason="slot" if not self._free_slots else "pages")
        return bool(self._free_slots) and self._pages_ok(cand)

    def sweep_deadlines(self) -> None:
        """The deadline sweep ``step_plan`` runs first; the engine runs
        it itself before planning (``step_plan(sweep=False)``)."""
        self._expire_deadlines()

    def step_plan(self, sweep: bool = True) -> Plan:
        """ONE mixed plan, after the deadline sweep (``sweep=False``
        skips it): the prefill lane's next chunk row (admitting the next
        candidate into the lane when it is free) packed with a decode
        row for every running slot not on ``async_hold``."""
        if sweep:
            self._expire_deadlines()
        chunk_row = None
        if self._chunking is None:
            cand = self._admission_candidate()
            if cand is not None:
                self._admit(cand)
        if self._chunking is not None:
            chunk_row = self._next_chunk_row(self._chunking)
        rows = [chunk_row] if chunk_row is not None else []
        decode_rows = self._decode_rows()
        rows.extend(decode_rows)
        if not rows:
            return Plan(kind="idle")
        if decode_rows:
            self.stats["n_decode_steps"] += 1
        return Plan(kind="mixed", rows=rows)

    def _decode_rows(self) -> List[RowPlan]:
        """One pending-token row per RUNNING slot, in slot order; slots
        on ``async_hold`` sit the step out."""
        return [RowPlan(kind="decode", request=r)
                for slot, r in sorted(self.running.items())
                if r.state == RUNNING and slot not in self.async_hold]

    def _admit(self, req: Request) -> None:
        """Move ``req`` from its queue into a slot and hand it the
        prefill lane; host-swapped pages past the device prefix hit are
        written back first, so only the rest streams in as chunk rows."""
        self._queues[req.priority].remove(req)
        self._quota_evented.discard(req.rid)
        resumed = req.preemptions > 0 and req.state == PREEMPTED
        ctx = req.kv_tokens()
        hashes = self._hashes_for(req)
        slot = self._free_slots.pop()
        if not self.cache.allocate(slot, self._need_tokens(req), prompt=ctx,
                                   hashes=hashes):
            raise RuntimeError("admission check and allocator disagree")
        req.slot = slot
        req.state = PREFILL
        req.t_admit = time.perf_counter()
        self._slo.observe("queue_wait", req.tenant, req.priority,
                          req.t_admit - req.t_submit)
        req.pages_reserved = self.cache.config.pages_for(
            self._need_tokens(req))
        swapped = self.cache.swap_in(slot, ctx, hashes=hashes)
        req.prefix_len = self.cache.prefix_len(slot)
        req.prefill_pos = req.prefix_len
        # "restored": served from cache or swap at the RE-admission of a
        # preempted request (a fresh request's prefix hit is not one)
        req.restored_tokens = req.prefix_len if resumed else 0
        self.running[slot] = req
        self._chunking = req
        self.stats["n_prefills"] += 1
        self._obs["queue_depth"].set(self.num_waiting)
        self._obs["running_slots"].set(len(self.running))
        self._last_bp_rid = -1
        if resumed:
            self.stats["n_resumed"] += 1
            self._rec.emit("request", "restore", rid=req.rid, slot=slot,
                           cached_tokens=req.prefix_len,
                           swapped_pages=swapped,
                           context_tokens=len(ctx))
        # the queue phase renders as one slice on the request track
        self._rec.emit("request", "queue_wait", rid=req.rid,
                       ts=req.t_submit,
                       dur=req.t_admit - req.t_submit,
                       slot=slot,
                       tail_tokens=len(ctx) - req.prefill_pos,
                       pages=req.pages_reserved,
                       cached_tokens=req.prefix_len)

    def _next_chunk_row(self, req: Request) -> RowPlan:
        """The next chunk row of the request owning the prefill lane,
        capped by the chunk budget and the step token budget (when
        set); otherwise the whole remaining context rides as one row."""
        ctx_len = len(req.kv_tokens())
        start = req.prefill_pos
        chunk_len = ctx_len - start
        if self.config.chunk_tokens > 0:
            chunk_len = min(chunk_len, self.config.chunk_tokens)
        budget = self.effective_step_budget()
        if budget > 0:
            chunk_len = min(chunk_len, budget)
        chunk_len = max(chunk_len, 1)
        first = req.prefill_chunks == 0
        final = start + chunk_len >= ctx_len
        req.prefill_chunks += 1
        self.stats["n_chunks"] += 1
        return RowPlan(kind="chunk", request=req, start=start,
                       chunk_len=chunk_len, first_chunk=first,
                       final_chunk=final)

    # ---------------------------------------- deadlines / cancel / preempt --
    def _deadline_hit(self, req: Request, now: float) -> bool:
        if req.deadline_s > 0 and now - req.t_submit >= req.deadline_s:
            return True
        return (req.ttft_deadline_s > 0 and req.t_first_token == 0.0
                and now - req.t_submit >= req.ttft_deadline_s)

    def _expire_deadlines(self) -> None:
        """Time out waiting and running requests past a deadline, between
        engine steps (never mid-dispatch)."""
        if self._live_deadlines == 0:
            return
        now = time.perf_counter()
        for q in self._queues:
            for req in [r for r in q if self._deadline_hit(r, now)]:
                if req.state == FINISHED or req not in q:
                    continue           # a cancel raced the sweep
                q.remove(req)
                self._rec.emit("request", "timeout", rid=req.rid,
                               stage=req.state)
                self._retire(req, "timeout")
        for req in [r for r in self.running.values()
                    if self._deadline_hit(r, now)]:
            if req.state == FINISHED or self.running.get(req.slot) is not req:
                continue
            self._rec.emit("request", "timeout", rid=req.rid,
                           stage=req.state)
            self._teardown_slot(req, recycled=True, cause="timeout")
            self._retire(req, "timeout")
        self._obs["queue_depth"].set(self.num_waiting)

    def cancel(self, rid: int) -> bool:
        """Tear down request ``rid`` queued, mid-prefill, mid-decode or
        mid-verify, restoring its pages and finishing it with
        ``finish_reason='cancelled'``. False when the rid is unknown or
        already terminal. Call between engine steps."""
        req = self.requests.get(rid)
        if req is None or req.state == FINISHED:
            return False
        stage = req.state
        if req.slot >= 0:
            self._teardown_slot(req, recycled=True, cause="cancelled")
        else:
            self._queues[req.priority].remove(req)
            self._obs["queue_depth"].set(self.num_waiting)
        self._rec.emit("request", "cancel", rid=rid, stage=stage,
                       tokens=len(req.output))
        self._retire(req, "cancelled")
        return True

    def shed_queued(self, max_n: int, retry_after_s: float,
                    min_class: int = 1) -> int:
        """Brownout load shedding: retire up to ``max_n`` QUEUED
        requests from the lowest-priority classes (never below
        ``min_class``), newest first within a class, each with
        ``finish_reason='shed'`` and the controller's ``retry_after_s``
        attached. Returns requests shed."""
        retry = max(float(retry_after_s), 1e-3)
        shed = 0
        for pr in range(len(self._queues) - 1, min_class - 1, -1):
            q = self._queues[pr]
            while q and shed < max_n:
                req = q.pop()          # newest arrival of the class
                req.retry_after_s = retry
                shed += 1
                self.stats["n_shed"] += 1
                self._obs["shed"].labels(priority=str(pr)).inc()
                self._rec.emit("request", "shed", rid=req.rid,
                               priority=pr, retry_after_s=retry,
                               stage="queued")
                self._retire(req, "shed")
            if shed >= max_n:
                break
        if shed:
            self._obs["queue_depth"].set(self.num_waiting)
        return shed

    def fault_terminate(self, req: Request, kind: str = "nan") -> bool:
        """Device-fault quarantine: terminate ONE request whose step
        results are poisoned (non-finite logits, a failed dispatch)
        with its pages restored and ``finish_reason='device_fault'``.
        The engine's fault boundary calls this for the offending rows
        only. Idempotent."""
        if req.state == FINISHED:
            return False
        stage = req.state
        if req.slot >= 0 and self.running.get(req.slot) is req:
            self._teardown_slot(req, recycled=True, cause="device_fault")
        elif req in self._queues[req.priority]:
            self._queues[req.priority].remove(req)
            self._obs["queue_depth"].set(self.num_waiting)
        self.stats["n_device_faults"] += 1
        self._obs["device_faults"].labels(kind=kind).inc()
        self._rec.emit("request", "device_fault", rid=req.rid, kind=kind,
                       stage=stage, tokens=len(req.output))
        self._retire(req, "device_fault")
        return True

    def preempt(self, rid: int, requeue: bool = True,
                reason: str = "manual") -> bool:
        """Evict running request ``rid`` (tests, operators); the SLO path
        calls :meth:`preempt_request`."""
        req = self.requests.get(rid)
        if req is None:
            return False
        return self.preempt_request(req, reason=reason, requeue=requeue)

    def preempt_request(self, req: Request, reason: str = "slo",
                        requeue: bool = True) -> bool:
        """Evict ``req`` from its slot: register its full resident pages
        in the prefix cache and copy them to the host swap tier, release
        the slot, and re-queue it at the FRONT of its class. When it
        cannot re-queue (queue full, or ``requeue=False``) it ends with
        ``finish_reason='preempted'``."""
        if req.state not in (PREFILL, RUNNING) or req.slot < 0:
            return False
        slot = req.slot
        n_res = int(self.cache.seq_lens[slot])
        cc = self.cache.config
        swapped = 0
        if n_res >= cc.page_size and (cc.prefix_cache or cc.swap_pages > 0):
            # full pages of the RESIDENT context only: pages past
            # seq_lens hold garbage mid-prefill
            resident = req.kv_tokens()[:n_res]
            h = self.cache._block_hashes(resident)
            self.cache.commit_prefix(slot, resident, hashes=h)
            swapped = self.cache.swap_out(slot, resident, hashes=h)
        self._teardown_slot(req, cause="preempted")
        req.state = PREEMPTED
        req.preemptions += 1
        req.t_preempt = time.perf_counter()
        req.prefill_pos = 0
        req.prefix_len = 0
        req.prefill_chunks = 0
        req.pages_reserved = 0
        req.block_hashes = None          # the context grew by the output
        req.spec_len = self.config.spec_tokens
        req.spec_window.clear()
        req.spec_idle = 0
        self.stats["n_preemptions"] += 1
        self._obs["preemptions"].labels(reason=reason).inc()
        can_requeue = requeue and self.num_waiting < self.config.max_queue
        self._rec.emit("request", "preempt", rid=req.rid, slot=slot,
                       reason=reason, resident_tokens=n_res,
                       swapped_pages=swapped, requeued=can_requeue,
                       tokens=len(req.output))
        if can_requeue:
            self._queues[req.priority].appendleft(req)
            self._obs["queue_depth"].set(self.num_waiting)
        else:
            self.stats["n_preempt_drops"] += 1
            self._retire(req, "preempted")
        return True

    def _teardown_slot(self, req: Request, recycled: bool = False,
                       cause: str = "finished") -> None:
        """Detach ``req`` from its slot and return its pages — shared by
        finish, cancel, timeout and preemption. ``recycled`` marks a
        terminal slot return (a preemption is counted apart); ``cause``
        names the teardown to the engine's ``teardown_hook``, which
        dead-marks the request's rows still in flight."""
        slot = req.slot
        if self.teardown_hook is not None:
            self.teardown_hook(req, slot, cause)
        if self._chunking is req:
            self._chunking = None
        self.cache.release(slot)
        del self.running[slot]
        self._free_slots.append(slot)
        req.slot = -1
        self._obs["running_slots"].set(len(self.running))
        if recycled:
            self.stats["n_recycled"] += 1
            self._obs["recycled"].inc()
            self._rec.emit("request", "recycled", rid=req.rid, slot=slot,
                           free_pages=self.cache.num_free_pages)

    def _retire(self, req: Request, reason: str) -> None:
        """Terminal bookkeeping (the slot, if any, is already torn down).
        Idempotent once: a request reaches its terminal state exactly
        one time, so a sweep racing a cancel neither double-counts nor
        overwrites the first reason."""
        if req.state == FINISHED:
            return
        req.state = FINISHED
        req.finish_reason = reason
        req.t_finish = time.perf_counter()
        self._quota_evented.discard(req.rid)
        if req.ttft_deadline_s > 0 or req.deadline_s > 0:
            self._live_deadlines -= 1
        self.stats["n_finished"] += 1
        self._obs["finished"].inc()
        if reason == "timeout":
            self.stats["n_timeouts"] += 1
            self._obs["timeouts"].inc()
        elif reason == "cancelled":
            self.stats["n_cancelled"] += 1
            self._obs["cancels"].inc()
        if self.journal is not None:
            self.journal.record_finish(req.rid, reason)
        self.finished[req.rid] = req
        self.recent_finished.append(req.rid)
        # the whole decode phase as one slice, then the terminal marker
        if req.t_first_token:
            self._rec.emit("request", "decode", rid=req.rid,
                           ts=req.t_first_token,
                           dur=req.t_finish - req.t_first_token,
                           tokens=len(req.output))
        self._rec.emit("request", "finished", rid=req.rid,
                       ts=req.t_finish, reason=reason,
                       tokens=len(req.output))

    # ----------------------------------------------------------- results --
    def on_chunk_done(self, req: Request, plan: RowPlan,
                      first_token: Optional[int] = None,
                      eos_id: Optional[int] = None) -> None:
        """One chunk row's K/V is resident. A non-final chunk advances
        the prefill cursor; the final chunk completes the prefill (the
        engine sampled the first token from the row's last position).
        The updates are monotone (max): under async pipelining the
        engine advanced them at dispatch, and this lagged call must not
        walk them back past a later chunk in flight."""
        req.prefill_pos = max(req.prefill_pos, plan.start + plan.chunk_len)
        self.cache.seq_lens[req.slot] = max(
            int(self.cache.seq_lens[req.slot]), plan.start + plan.chunk_len)
        if not plan.final_chunk:
            return
        ctx = req.kv_tokens()
        if req.prefill_pos != len(ctx):
            raise RuntimeError("final chunk did not complete the context")
        if self._chunking is req:
            self._chunking = None
        self.cache.commit_prefix(req.slot, ctx, hashes=self._hashes_for(req))
        req.state = RUNNING
        self._emit(req, first_token, eos_id)

    def on_verify_done(self, emitted: Dict[int, List[int]],
                       eos_id: Optional[int]) -> Dict[int, int]:
        """``emitted``: slot -> the tokens its decode or verify row
        landed, in order (one for a plain decode row; accepted drafts
        plus the bonus or corrected token for a verify row). The engine
        has already set ``cache.seq_lens`` and rolled rejected draft
        K/V back. An EOS inside the block retires the slot at once and
        drops the tokens after it. Returns slot -> tokens delivered."""
        delivered: Dict[int, int] = {}
        for slot, tokens in emitted.items():
            req = self.running.get(slot)
            if req is None or req.state != RUNNING:
                continue
            n = 0
            for token in tokens:
                self._emit(req, int(token), eos_id)
                n += 1
                if req.state != RUNNING:
                    break
            delivered[slot] = n
        return delivered

    def _emit(self, req: Request, token: int, eos_id: Optional[int]) -> None:
        now = time.perf_counter()
        req.output.append(token)
        if self.journal is not None:
            self.journal.record_tokens(req.rid, (token,))
        if req.t_first_token == 0.0:
            req.t_first_token = now
            self._slo.observe("ttft", req.tenant, req.priority,
                              now - req.t_submit)
        else:
            # the gap since the previous delivered token is the ITL a
            # streaming caller sees (a verify step landing several
            # tokens at once yields near-zero gaps: real burstiness)
            self._slo.observe("itl", req.tenant, req.priority,
                              now - req.t_last_token)
            if len(req.output) % DECODE_PROGRESS_EVERY == 0:
                self._rec.emit("request", "decode_progress", rid=req.rid,
                               tokens=len(req.output))
        req.t_last_token = now
        req.token_times.append(now)
        if eos_id is not None and token == eos_id:
            self._finish(req, "eos")
        elif len(req.output) >= req.max_new_tokens:
            self._finish(req, "max_new_tokens")

    def _finish(self, req: Request, reason: str) -> None:
        self._teardown_slot(req, recycled=True, cause="finished")
        self._retire(req, reason)

    @property
    def has_work(self) -> bool:
        return bool(self.num_waiting or self.running)
