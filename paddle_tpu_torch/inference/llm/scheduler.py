"""Continuous-batching scheduler (policy only — no device code).

Counterpart of ``paddle_tpu/inference/llm/scheduler.py`` for the
unified mixed-step plan. The scheduler owns WHAT runs each step; the
``GenerationEngine`` owns HOW it runs.

- **Admission control**: a bounded FIFO waiting queue (``max_queue``);
  ``submit`` raises ``QueueFull`` beyond it.
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

Priority classes, tenant quotas, deadlines, preemption, brownout
shedding (so ``spec_suspended`` stays False), async pipelining,
quantized collectives and the int8 matmul are later slices of the port:
their knobs exist so a config reads like the JAX one, and a non-default
value raises ``NotImplementedError`` naming the slice.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from . import policy
from .kv_cache import PagedKVCache

__all__ = ["SchedulerConfig", "Request", "QueueFull", "InvalidRequest",
           "ContinuousBatchingScheduler", "Plan", "RowPlan",
           "ragged_buckets"]

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", \
    "finished"


class QueueFull(RuntimeError):
    """Admission control rejected the request (queue depth exceeded)."""


class InvalidRequest(ValueError):
    """Typed rejection of a malformed submit (empty prompt, non-positive
    ``max_new_tokens``, a prompt that cannot fit the engine or pool),
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
    # later slices: only the defaults are accepted (see __post_init__)
    async_depth: int = policy.ASYNC_DEPTH
    tenant_max_pages: int = 0
    tenant_max_slots: int = 0
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
        later = (("async_depth", "async pipelining"),
                 ("tenant_max_pages", "multi-tenant admission"),
                 ("tenant_max_slots", "multi-tenant admission"),
                 ("brownout_levels", "overload brownout"))
        for knob, slice_name in later:
            if getattr(self, knob) != 0:
                raise _later_slice(knob, getattr(self, knob), slice_name)
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

    def kv_tokens(self) -> List[int]:
        """prompt + generated output — every token whose KV must be
        resident before the request can take another decode step."""
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
        self._queue: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self.finished: Dict[int, Request] = {}     # rid -> request
        self.requests: Dict[int, Request] = {}     # rid -> request
        self._free_slots = list(range(config.max_slots - 1, -1, -1))
        self._chunking: Optional[Request] = None   # owner of the prefill lane
        self._next_rid = 0
        # speculative-decoding totals (engine-updated): verify steps,
        # slot participations in them, drafted / accepted / emitted tokens
        self.stats = {"n_spec_steps": 0, "n_spec_slot_steps": 0,
                      "n_spec_drafted": 0, "n_spec_accepted": 0,
                      "n_spec_emitted": 0}
        # brownout turns drafting off; the port has no brownout yet
        self.spec_suspended = False

    # -------------------------------------------------------------- views --
    @property
    def num_waiting(self) -> int:
        return len(self._queue)

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
        if priority != 0:
            raise _later_slice("priority", priority, "multi-tenant admission")
        if ttft_deadline_s or deadline_s:
            raise _later_slice("deadline_s",
                               deadline_s or ttft_deadline_s, "deadlines")

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               sampling=None, priority: int = 0,
               ttft_deadline_s: float = 0.0, deadline_s: float = 0.0) -> int:
        self._validate_submit(prompt, max_new_tokens, priority,
                              ttft_deadline_s, deadline_s)
        if self.num_waiting >= self.config.max_queue:
            raise QueueFull(
                f"serving queue full ({self.config.max_queue} pending)")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, sampling=sampling,
                      spec_len=self.config.spec_tokens)
        self._queue.append(req)
        self.requests[rid] = req
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
        if req.block_hashes is None:
            req.block_hashes = (self.cache._block_hashes(req.kv_tokens())
                                if self.cache.config.prefix_cache else [])
        return req.block_hashes

    def _need_tokens(self, req: Request) -> int:
        return len(req.prompt) + req.max_new_tokens

    def _admission_candidate(self) -> Optional[Request]:
        """The queue head when a slot and its pages are free; else None
        (FIFO: nothing behind a blocked head is admitted)."""
        if not self._queue:
            return None
        req = self._queue[0]
        if self._free_slots and self.cache.can_allocate(
                self._need_tokens(req), prompt=req.kv_tokens(),
                hashes=self._hashes_for(req)):
            return req
        return None

    def step_plan(self) -> Plan:
        """ONE mixed plan: the prefill lane's next chunk row (admitting
        the queue head into the lane when it is free) packed with a
        decode row for every running slot."""
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
        return Plan(kind="mixed", rows=rows)

    def _decode_rows(self) -> List[RowPlan]:
        """One pending-token row per RUNNING slot, in slot order."""
        return [RowPlan(kind="decode", request=r)
                for _, r in sorted(self.running.items())
                if r.state == RUNNING]

    def _admit(self, req: Request) -> None:
        """Move ``req`` from the queue into a slot and hand it the
        prefill lane: its context streams in as chunk rows."""
        self._queue.popleft()
        ctx = req.kv_tokens()
        slot = self._free_slots.pop()
        if not self.cache.allocate(slot, self._need_tokens(req), prompt=ctx,
                                   hashes=self._hashes_for(req)):
            raise RuntimeError("admission check and allocator disagree")
        req.slot = slot
        req.state = PREFILL
        req.prefill_pos = self.cache.prefix_len(slot)
        self.running[slot] = req
        self._chunking = req

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
        return RowPlan(kind="chunk", request=req, start=start,
                       chunk_len=chunk_len, first_chunk=first,
                       final_chunk=final)

    # ------------------------------------------------------------ cancel --
    def cancel(self, rid: int) -> bool:
        """Tear down request ``rid`` queued, mid-prefill or mid-decode,
        restoring its pages and finishing it with ``finish_reason=
        'cancelled'``. False when the rid is unknown or already
        terminal. Call between engine steps."""
        req = self.requests.get(rid)
        if req is None or req.state == FINISHED:
            return False
        if req.slot >= 0:
            self._teardown_slot(req)
        else:
            self._queue.remove(req)
        self._retire(req, "cancelled")
        return True

    def _teardown_slot(self, req: Request) -> None:
        """Detach ``req`` from its slot and return its pages."""
        slot = req.slot
        if self._chunking is req:
            self._chunking = None
        self.cache.release(slot)
        del self.running[slot]
        self._free_slots.append(slot)
        req.slot = -1

    def _retire(self, req: Request, reason: str) -> None:
        """Terminal bookkeeping (the slot, if any, is already torn
        down); a request reaches its terminal state exactly once."""
        if req.state == FINISHED:
            return
        req.state = FINISHED
        req.finish_reason = reason
        self.finished[req.rid] = req

    # ----------------------------------------------------------- results --
    def on_chunk_done(self, req: Request, plan: RowPlan,
                      first_token: Optional[int] = None,
                      eos_id: Optional[int] = None) -> None:
        """One chunk row's K/V is resident. A non-final chunk advances
        the prefill cursor; the final chunk completes the prefill (the
        engine sampled the first token from the row's last position)."""
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
        if eos_id is not None and token == eos_id:
            self._finish(req, "eos")
        elif len(req.output) >= req.max_new_tokens:
            self._finish(req, "max_new_tokens")

    def _finish(self, req: Request, reason: str) -> None:
        self._teardown_slot(req)
        self._retire(req, reason)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self.running)
