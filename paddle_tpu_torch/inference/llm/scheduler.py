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

Brownout shedding (so ``spec_suspended`` stays False), quantized
collectives and the int8 matmul are later slices of the port: their
knobs exist so a config reads like the JAX one, and a non-default value
raises ``NotImplementedError`` naming the slice.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from . import policy
from .kv_cache import PagedKVCache

__all__ = ["SchedulerConfig", "Request", "QueueFull", "InvalidRequest",
           "ContinuousBatchingScheduler", "Plan", "RowPlan",
           "ragged_buckets"]

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", \
    "finished"
PREEMPTED = "preempted"


class QueueFull(RuntimeError):
    """Admission control rejected the request (queue depth exceeded)."""


class InvalidRequest(ValueError):
    """Typed rejection of a malformed submit (empty prompt, non-positive
    ``max_new_tokens``, a prompt that cannot fit the engine, pool or
    tenant quota, a priority outside the classes, a negative deadline),
    raised before a rid is assigned."""


def _later_slice(knob: str, value, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} needs the {slice_name} slice of the PyTorch "
        "port, which is not ported yet")


def ragged_buckets(min_bucket: int, max_ragged_tokens: int) -> List[int]:
    """Log-spaced TOTAL-ragged-token buckets of the unified mixed step:
    min_bucket, 2*min_bucket, ... up to (and including) the most tokens
    one step can pack."""
    buckets = []
    b = max(min_bucket, 1)
    while b < max_ragged_tokens:
        buckets.append(b)
        b *= 2
    buckets.append(max_ragged_tokens)
    return buckets


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
    # a later slice (overload brownout): only 0 is accepted
    brownout_levels: int = 0
    # quantized serving: KV-page storage mode (off | int8 | fp8) and
    # weight storage mode (off | int8). The scheduler never reads them
    # (page accounting is encoding-agnostic); an engine built without an
    # explicit QuantConfig does.
    kv_quant: str = policy.KV_QUANT
    weight_quant: str = policy.WEIGHT_QUANT
    # later slices (quantized mesh collectives, the int8 x int8 matmul):
    # only "off" is accepted
    coll_quant: str = "off"
    weight_matmul: str = "off"
    # flash-decode KV split: chunk width in pages of the attention
    # kernels' split page walk (0 = off). A kernel schedule knob the
    # engine reads; the scheduler never does.
    kv_split_pages: int = policy.KV_SPLIT_PAGES

    def __post_init__(self):
        if self.brownout_levels != 0:
            raise _later_slice("brownout_levels", self.brownout_levels,
                               "overload brownout")
        if self.coll_quant != "off":
            raise _later_slice("coll_quant", self.coll_quant,
                               "tensor-parallel mesh")
        if self.weight_matmul != "off":
            raise _later_slice("weight_matmul", self.weight_matmul,
                               "int8-matmul")

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
    finish_reason: str = ""        # eos | max_new_tokens | cancelled
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
        self._free_slots = list(range(config.max_slots - 1, -1, -1))
        self._chunking: Optional[Request] = None   # owner of the prefill lane
        self._next_rid = 0
        # lifecycle counts, and the speculative-decoding totals (engine-
        # updated): verify steps, slot participations in them, drafted /
        # accepted / emitted tokens
        self.stats = {"n_submitted": 0, "n_rejected": 0, "n_prefills": 0,
                      "n_chunks": 0, "n_backpressure": 0, "n_recycled": 0,
                      "n_finished": 0,
                      "n_spec_steps": 0, "n_spec_slot_steps": 0,
                      "n_spec_drafted": 0, "n_spec_accepted": 0,
                      "n_spec_emitted": 0,
                      "n_preemptions": 0, "n_resumed": 0,
                      "n_preempt_drops": 0, "n_timeouts": 0,
                      "n_cancelled": 0, "n_quota_deferred": 0}
        # live requests carrying a deadline: the sweep is skipped while
        # this is zero
        self._live_deadlines = 0
        # brownout turns drafting off; the port has no brownout yet
        self.spec_suspended = False
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
        if self.num_waiting >= self.config.max_queue:
            self.stats["n_rejected"] += 1
            raise QueueFull(
                f"serving queue full ({self.config.max_queue} pending)")
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
        return rid

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
        return blocked

    def _admission_candidate(self, allow_preempt: bool = True
                             ) -> Optional[Request]:
        """Scan the classes in priority order, FIFO within a class.
        Quota-blocked requests are skipped; the first request blocked
        on a slot or pages ends the scan, after a preemption attempt, so
        nothing later or of lower priority starves it."""
        if self.num_waiting == 0:
            return None
        quotas_on = (self.config.tenant_max_slots > 0
                     or self.config.tenant_max_pages > 0)
        usage = self._tenant_usage() if quotas_on else None
        for q in self._queues:
            for req in q:
                if quotas_on and self._quota_blocked(req, usage):
                    continue
                if self._free_slots and self._pages_ok(req):
                    return req
                if allow_preempt and self._try_preempt_for(req):
                    return req
                self.stats["n_backpressure"] += 1
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
        rows.extend(self._decode_rows())
        if not rows:
            return Plan(kind="idle")
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
        req.pages_reserved = self.cache.config.pages_for(
            self._need_tokens(req))
        self.cache.swap_in(slot, ctx, hashes=hashes)
        req.prefix_len = self.cache.prefix_len(slot)
        req.prefill_pos = req.prefix_len
        # "restored": served from cache or swap at the RE-admission of a
        # preempted request (a fresh request's prefix hit is not one)
        req.restored_tokens = req.prefix_len if resumed else 0
        self.running[slot] = req
        self._chunking = req
        self.stats["n_prefills"] += 1
        if resumed:
            self.stats["n_resumed"] += 1

    def _next_chunk_row(self, req: Request) -> RowPlan:
        """The next chunk row of the request owning the prefill lane,
        capped by the chunk budget and the step token budget (when
        set); otherwise the whole remaining context rides as one row."""
        ctx_len = len(req.kv_tokens())
        start = req.prefill_pos
        chunk_len = ctx_len - start
        if self.config.chunk_tokens > 0:
            chunk_len = min(chunk_len, self.config.chunk_tokens)
        if self.config.step_token_budget > 0:
            chunk_len = min(chunk_len, self.config.step_token_budget)
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
                self._retire(req, "timeout")
        for req in [r for r in self.running.values()
                    if self._deadline_hit(r, now)]:
            if req.state == FINISHED or self.running.get(req.slot) is not req:
                continue
            self._teardown_slot(req, recycled=True, cause="timeout")
            self._retire(req, "timeout")

    def cancel(self, rid: int) -> bool:
        """Tear down request ``rid`` queued, mid-prefill, mid-decode or
        mid-verify, restoring its pages and finishing it with
        ``finish_reason='cancelled'``. False when the rid is unknown or
        already terminal. Call between engine steps."""
        req = self.requests.get(rid)
        if req is None or req.state == FINISHED:
            return False
        if req.slot >= 0:
            self._teardown_slot(req, recycled=True, cause="cancelled")
        else:
            self._queues[req.priority].remove(req)
        self._retire(req, "cancelled")
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
        if n_res >= cc.page_size and (cc.prefix_cache or cc.swap_pages > 0):
            # full pages of the RESIDENT context only: pages past
            # seq_lens hold garbage mid-prefill
            resident = req.kv_tokens()[:n_res]
            h = self.cache._block_hashes(resident)
            self.cache.commit_prefix(slot, resident, hashes=h)
            self.cache.swap_out(slot, resident, hashes=h)
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
        if requeue and self.num_waiting < self.config.max_queue:
            self._queues[req.priority].appendleft(req)
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
        if recycled:
            self.stats["n_recycled"] += 1

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
        if req.ttft_deadline_s > 0 or req.deadline_s > 0:
            self._live_deadlines -= 1
        self.stats["n_finished"] += 1
        if reason == "timeout":
            self.stats["n_timeouts"] += 1
        elif reason == "cancelled":
            self.stats["n_cancelled"] += 1
        self.finished[req.rid] = req

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
        req.output.append(token)
        if req.t_first_token == 0.0:
            req.t_first_token = time.perf_counter()
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
