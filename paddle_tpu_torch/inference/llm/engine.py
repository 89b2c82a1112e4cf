"""``GenerationEngine``: continuous-batching autoregressive decoding.

Counterpart of ``paddle_tpu/inference/llm/engine.py``'s paged path,
serial (async depth 0), single device, float32 activations with
optional int8/fp8 KV pages and weight-only int8 (``quant``), and the
attention kernels' flash-decode KV split
(``SchedulerConfig.kv_split_pages``). Every engine step is a
MIXED step: the scheduler's plan packs a prefill-chunk row (a whole
prompt when chunking is off; a prefix-cache hit packs only the tail)
and one decode row per running slot into a flat ragged token block,
bucket-padded to the same ragged-token buckets as the JAX engine. One
step (:func:`_step`, the body of the JAX engine's ``_step_jit_for``)
scatters every row's new K/V into its slot's pages, attends the whole
block through the page table with the ragged attention kernel, and
samples with per-(request seed, token index) threefry keys — so sampled
outputs equal the JAX engine's and do not depend on batching or
scheduling order.

Speculative decoding (``SchedulerConfig.spec_tokens > 0``): before a
step the engine proposes n-gram drafts from each decoding slot's own
context (:func:`ngram_draft`, no draft model) and widens that slot's
decode row into a verify row (the pending token plus its drafts). The
step samples every position of such a row with its own key; landing
accepts the longest draft prefix the target agrees with, emits the
accepted tokens plus one, and rolls the rejected tail's K/V back with
``PagedKVCache.truncate``. Sampling keys depend only on (seed, token
index), so tokens with speculation on equal tokens with it off.

Async pipelining (``SchedulerConfig.async_depth = D > 0``): the host
plans and dispatches step N+1 while step N runs, and lands N's results
one step later (:meth:`GenerationEngine._step_async`). A pipelined
decode row takes its pending token from the device-resident carry
(``resolve_carry_tokens``/``step_carry``), never from the host; a
request torn down with rows still in flight (finish, cancel, timeout,
preemption) has those rows dead-marked and skipped at commit. Tokens
are a pure function of (seed, token index), so depths 0, 1 and 2 give
the same tokens.

CUDA graphs (on the card, by default): each step signature — its
ragged bucket, and whether any row has more than one query — is
captured once into a ``torch.cuda.CUDAGraph`` (embeddings through
sampling, the ragged attention kernels included) and replayed after,
with the step's metadata copied into the graph's static inputs. The
graphs are the port's form of the JAX engine's one compiled executable
per bucket; ``xla_compiles`` counts them, within ``graph_bound``.

Preemption, priorities, tenant quotas and deadlines are the scheduler's
(see ``scheduler.py``); the host swap tier is the cache's. The request
journal, fault injection and the NaN quarantine, brownout, the
tensor-parallel mesh and the observability hooks are later slices of
the port.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import weakref
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ...device import resolve_device
from ...kernels import paged_attention as pa
from ...kernels.paged_attention import DECODE_MAX_Q
from .kv_cache import CacheConfig, PagedKVCache, flatten_page_levels
from .model import TorchLM, lm_ragged_step, resolve_carry_tokens, step_carry
from .policy import (SPEC_DECAY_BELOW, SPEC_GROW_ABOVE, SPEC_NGRAM_MAX,
                     SPEC_NGRAM_MIN, SPEC_PROBE_EVERY, SPEC_WINDOW)
from .quant import QuantConfig
from .scheduler import (ContinuousBatchingScheduler, Plan, QueueFull,
                        RowPlan, SchedulerConfig)
from .threefry import categorical, fold_in, prng_key

__all__ = ["SamplingParams", "GREEDY", "resolve_sampling", "ngram_draft",
           "GenerationEngine"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy; top_k <= 0 and top_p >= 1 -> full
    distribution. Token i of a request is sampled with the key
    ``fold_in(PRNGKey(seed), i)``; ``seed=None`` draws one per request
    at submit."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None


GREEDY = SamplingParams()


def resolve_sampling(sampling: Optional[SamplingParams],
                     rng: np.random.Generator) -> SamplingParams:
    """``None`` means greedy; a ``seed=None`` request draws its seed
    from ``rng`` — one ``integers(1 << 31)`` draw, exactly as the JAX
    engine does, so both assign the same seeds in submission order."""
    sp = sampling or GREEDY
    if sp.seed is None:
        sp = dataclasses.replace(sp, seed=int(rng.integers(1 << 31)))
    return sp


def _sample_traced(logits, seeds, positions, temperature, top_k, top_p):
    """``[B, V]`` logits -> ``[B]`` int32 tokens, every knob a tensor.

    Row b's key is ``fold_in(PRNGKey(seeds[b]), positions[b])``. The
    temperature is clamped at 1e-6; top-k/top-p act on a stable
    descending sort (rank < top_k keeps the k best, ``top_k <= 0``
    keeps all; the nucleus keeps ranks whose preceding cumulative
    probability is below ``top_p``, and rank 0 always); the draw is the
    Gumbel-max ``categorical``. ``temperature <= 0`` rows take the
    first-max argmax."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits.to(torch.float32) / t
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, order)
    rank = torch.arange(V, device=logits.device)[None, :]
    k = torch.where(top_k[:, None] <= 0, torch.full_like(top_k[:, None], V),
                    top_k[:, None])
    keep = rank < k
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p[:, None]
    keep |= rank == 0
    masked = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, -torch.inf))
    keys = fold_in(prng_key(seeds), positions)
    picked = categorical(keys, masked)
    sampled = torch.gather(order, -1, picked[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def ngram_draft(context: np.ndarray, max_tokens: int,
                max_ngram: int = SPEC_NGRAM_MAX,
                min_ngram: int = SPEC_NGRAM_MIN) -> List[int]:
    """Prompt-lookup drafting: match the tail n-gram of ``context``
    (prompt + output so far) against the rest of the context and propose
    the tokens that followed an earlier occurrence, up to ``max_tokens``
    of them: the latest occurrence whose continuation fills the budget,
    else the earliest (its continuation is the longest). Longer n-grams
    are tried first; ``[]`` when nothing matches."""
    L = len(context)
    if max_tokens <= 0 or L < min_ngram + 1:
        return []
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        suffix = context[L - n:]
        # windows over context[:-1]: the suffix's own window needs the
        # final token, so it is excluded by construction
        windows = np.lib.stride_tricks.sliding_window_view(
            context[:L - 1], n)
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if len(hits):
            full = hits[hits + n + max_tokens <= L]
            start = int(full[-1] if len(full) else hits[0]) + n
            return context[start:start + max_tokens].tolist()
    return []


def _step(model: TorchLM, cache: PagedKVCache, page_levels, ints, floats,
          carry, bucket: int, attn_tier: str, max_q_len: int,
          quant: Optional[QuantConfig], kv_split_pages: int):
    """One unified step (the JAX engine's ``_step_jit_for`` body), the
    function a CUDA graph captures per ragged bucket.

    ``page_levels``: the two-level table ``(slot_dir, index_pool)`` on
    the device, flattened here to the ``[max_slots, pages_per_seq]``
    page table the step consumes. ``ints`` (int32) packs ``row_meta [3,
    max_slots]`` (q_starts / q_lens / kv_lens), ``tok_meta [5,
    bucket]`` (tokens / tok_src / seeds / sample_pos / top_k) and
    ``sample_idx [max_slots * (1 + spec_tokens) + 1]``; ``floats``
    (float32) packs ``samp_meta [2, bucket]`` (temperature / top_p).
    ``sample_idx`` lists the flat positions whose tokens landing reads
    (each chunk row's last one and every position of a decode or verify
    row), padded with ``bucket``, a position past the block that nothing
    reads: every step of a bucket samples the same number of rows, each
    with its own (seed, token index) key. Flat positions with
    ``tok_src >= 0`` take their input token from the device-resident
    ``carry`` (the previous step's last sampled token of that slot);
    ``carry`` is then updated in place. Updates the cache's pools in
    place and returns ``(toks [bucket], ok [bucket])``: the sampled
    tokens (0 where nothing was sampled) and whether each flat
    position's logits are all finite."""
    ms = carry.shape[0]
    row_meta = ints[:3 * ms].view(3, ms)
    tok_meta = ints[3 * ms:3 * ms + 5 * bucket].view(5, bucket)
    sample_idx = ints[3 * ms + 5 * bucket:].long()
    samp_meta = floats.view(2, bucket)
    q_starts, q_lens, kv_lens = row_meta[0], row_meta[1], row_meta[2]
    tokens, tok_src, seeds = tok_meta[0], tok_meta[1], tok_meta[2]
    sample_pos, top_k = tok_meta[3], tok_meta[4]
    temp, top_p = samp_meta[0], samp_meta[1]
    toks_in = resolve_carry_tokens(tokens, tok_src, carry)
    page_table = flatten_page_levels(page_levels[0], page_levels[1],
                                     cache.config.pages_per_seq)
    logits = lm_ragged_step(model.params, model.spec, toks_in, q_starts,
                            q_lens, kv_lens, cache.k_pool, cache.v_pool,
                            page_table, attn_tier=attn_tier,
                            max_q_len=max_q_len, k_scale=cache.k_scale,
                            v_scale=cache.v_scale, quant=quant,
                            kv_split_pages=kv_split_pages)
    src = torch.clamp(sample_idx, max=bucket - 1)
    toks = torch.zeros((bucket + 1,), dtype=torch.int32,
                       device=tokens.device)
    toks[sample_idx] = _sample_traced(logits[src], seeds[src],
                                      sample_pos[src], temp[src], top_k[src],
                                      top_p[src])
    toks = toks[:bucket]
    ok = torch.isfinite(logits).all(dim=-1)
    carry.copy_(step_carry(toks, q_starts, q_lens, carry))
    return toks, ok


def _teardown_hook(engine: "GenerationEngine"):
    """The scheduler's teardown hook for ``engine``, holding it weakly:
    the engine owns the scheduler, and a reference cycle would keep a
    dropped engine's pools and graphs on the card until a collection."""
    ref = weakref.ref(engine)

    def hook(req, slot: int, cause: str) -> None:
        eng = ref()
        if eng is not None:
            eng._on_slot_teardown(req, slot, cause)
    return hook


@dataclasses.dataclass
class _StepGraph:
    """One captured step: the CUDA graph, its static outputs, and the
    kernel launches it holds (added to the launch counts per replay)."""
    graph: object
    toks: torch.Tensor
    ok: torch.Tensor
    held: collections.Counter


@dataclasses.dataclass
class _Slot:
    """One entry of the card's ring of pinned host buffers: a step's
    staged metadata, its outputs copied back, and the event recorded
    after those copies."""
    ints: torch.Tensor
    floats: torch.Tensor
    toks: torch.Tensor
    ok: torch.Tensor
    event: object


@dataclasses.dataclass
class _InFlight:
    """One dispatched step (async pipelining: dispatched but not yet
    committed). It holds what the lagged commit needs to land the step
    as the serial engine would: the packed rows, the pack-time
    metadata, and where the results arrive (the host ring entry and its
    event on the card, host arrays on the CPU). ``dead`` collects the
    rids whose request was torn down after dispatch: their rows are
    skipped at commit, and a resumed request regenerates their tokens,
    since sampling is a pure function of (seed, token index)."""
    plan: Plan
    chunk_rows: List[RowPlan]
    decode_rows: List[RowPlan]
    drafts: Dict[int, List[int]]
    q_starts: np.ndarray
    q_lens: np.ndarray
    pre_lens: Dict[int, int]
    toks: object
    ok: object
    event: object = None
    dead: Set[int] = dataclasses.field(default_factory=set)


class GenerationEngine:
    """Ties scheduler + paged cache + model into a serving loop.

    ``device`` (default ``cuda``; pass ``"cpu"`` for the plain PyTorch
    path) must be where ``model`` lives. ``attn_tier``: ``"auto"`` (the
    CUDA kernel on the card, the plain version on the CPU), ``"kernel"``
    or ``"ref"``. ``quant`` (a :class:`QuantConfig`; ``None`` reads
    ``SchedulerConfig.kv_quant``/``weight_quant``) turns on quantized
    KV pages and weight-only int8; an explicit all-off config forces
    the float engine. ``cuda_graphs`` (default: on the card with the
    attention kernels; never on the CPU or with ``attn_tier="ref"``)
    runs each step as the replay of one CUDA graph per step signature
    (see :meth:`_dispatch`); ``False`` launches every step eagerly. A
    capture that fails raises: there is no eager fallback."""

    def __init__(self, model: TorchLM,
                 cache_config: Optional[CacheConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 eos_id: Optional[int] = None, attn_tier: str = "auto",
                 quant: Optional[QuantConfig] = None, device=None,
                 cuda_graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device} but the "
                             f"engine runs on {self.device}; build the "
                             "model on the engine's device")
        # a graph needs the card and the kernel tier: the plain attention
        # reads its row spans on the host, which a capture cannot hold
        graphs_ok = self.device.type == "cuda" and attn_tier != "ref"
        if cuda_graphs and not graphs_ok:
            raise ValueError("CUDA graphs need a CUDA device and the "
                             "attention kernels (attn_tier 'auto' or "
                             "'kernel'); the plain path runs every step "
                             "eagerly")
        self.cuda_graphs = graphs_ok if cuda_graphs is None else cuda_graphs
        # the reference is float32 end to end: no TF32 in matmuls or
        # convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.eos_id = eos_id
        self._attn_tier = attn_tier
        scheduler_config = scheduler_config or SchedulerConfig()
        if quant is None:
            quant = QuantConfig(kv=scheduler_config.kv_quant,
                                weights=scheduler_config.weight_quant)
        if not quant.active:
            quant = None
        self.quant = quant
        if quant is not None and quant.weights == "int8":
            self.model = model.quantize_weights()
        # the kernels' KV-split schedule: engine-constant, 0 = unsplit
        self._kv_split_pages = max(int(scheduler_config.kv_split_pages), 0)
        if cache_config is None:
            s = model.spec
            cache_config = CacheConfig(
                num_layers=s.num_layers, num_heads=s.num_heads,
                head_dim=s.head_dim, max_slots=scheduler_config.max_slots,
                max_seq_len=min(scheduler_config.max_seq_len, s.max_seq_len))
        if scheduler_config.max_seq_len > cache_config.max_seq_len:
            scheduler_config = dataclasses.replace(
                scheduler_config, max_seq_len=cache_config.max_seq_len)
        # the engine's quant config decides the page encoding: a
        # caller's cache config is aligned to it (a float pool under a
        # quantized step would scatter the wrong dtype)
        want = dict(
            kv_quant=quant.kv if quant is not None else "off",
            scale_dtype=(quant.scale_dtype if quant is not None
                         else cache_config.scale_dtype),
            weight_quant=quant.weights if quant is not None else "off")
        if any(getattr(cache_config, k) != v for k, v in want.items()):
            cache_config = dataclasses.replace(cache_config, **want)
        self.cache = PagedKVCache(cache_config, device=self.device)
        self.scheduler = ContinuousBatchingScheduler(self.cache,
                                                     scheduler_config)
        self._rng = np.random.default_rng(90210)
        ms = scheduler_config.max_slots
        # per-slot context (prompt + delivered tokens): the host source
        # of each decode row's pending token
        self._tok_matrix = np.zeros((ms, cache_config.max_seq_len),
                                    dtype=np.int32)
        self._row_len = np.zeros((ms,), dtype=np.int64)
        # the device copy of the two-level page table (static buffers,
        # rewritten in place when the host table changed) and the
        # device-resident carry of each slot's last sampled token
        self._levels_dev = (
            torch.zeros(self.cache.slot_dir.shape, dtype=torch.int32,
                        device=self.device),
            torch.zeros(self.cache.index_pool.shape, dtype=torch.int32,
                        device=self.device))
        self._levels_version = -1
        self.pt_uploads = 0
        self._carry_d = torch.zeros((ms,), dtype=torch.int32,
                                    device=self.device)
        # sample rows per step: every position of a decode or verify row
        # and each chunk row's last one, plus the pad
        self._n_sample = ms * (1 + max(scheduler_config.spec_tokens, 0)) + 1
        # ---- async pipelining (SchedulerConfig.async_depth) ----
        # up to async_depth steps dispatched ahead of their commit.
        # _carry_ok[slot]: the carry holds the slot's true last token (a
        # pipelined decode row may read it); _inflight_out[slot]: tokens
        # of the slot dispatched but not yet landed
        self.async_depth = max(int(scheduler_config.async_depth), 0)
        self._inflight: Deque[_InFlight] = deque()
        self._carry_ok = np.zeros((ms,), dtype=bool)
        self._inflight_out = np.zeros((ms,), dtype=np.int64)
        self.steps_dispatched = 0
        self.steps_committed = 0
        self.async_rollbacks = 0
        self.async_rollback_reasons: Dict[str, int] = {
            c: 0 for c in ("finished", "cancelled", "timeout", "preempted",
                           "device_fault")}
        # occupancy_hist[k]: mixed steps after whose commit phase k steps
        # were in flight (async_depth when the pipeline is full)
        self.occupancy_hist = [0] * (self.async_depth + 1)
        self.scheduler.teardown_hook = _teardown_hook(self)
        # ---- step dispatch ----
        # graph key ("step", bucket, tile rows) -> its captured graph
        # (None on the eager paths, where the key only counts as a
        # signature launched); steps by class: "decode" (every row one
        # query: no tile kernel) or "mix"
        self._graphs: Dict[tuple, Optional[_StepGraph]] = {}
        self.steps_by_class: "collections.Counter[str]" = \
            collections.Counter()
        self._inputs_dev: Dict[int, tuple] = {}
        self._ring: List[_Slot] = []
        self._ring_next = 0
        self._graph_pool = None

    # ------------------------------------------------------------ surface --
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, tenant: str = "default",
               ttft_deadline_s: float = 0.0, deadline_s: float = 0.0) -> int:
        # validate BEFORE the seed draw: a rejected submit burns nothing
        # of the per-request seed stream
        self.scheduler._validate_submit(prompt, max_new_tokens, priority,
                                        ttft_deadline_s, deadline_s)
        sp = resolve_sampling(sampling, self._rng)
        return self.scheduler.submit(prompt, max_new_tokens, sp,
                                     priority=priority, tenant=tenant,
                                     ttft_deadline_s=ttft_deadline_s,
                                     deadline_s=deadline_s)

    def cancel(self, rid: int) -> bool:
        """Tear down request ``rid`` at any stage with its pages restored
        and ``finish_reason='cancelled'``; its rows still in flight are
        dead-marked. False for unknown or terminal rids."""
        return self.scheduler.cancel(rid)

    @property
    def xla_compiles(self) -> int:
        """Distinct step signatures ``("step", bucket, tile rows)`` this
        engine launched: with CUDA graphs on, the graphs it captured.
        At most :attr:`graph_bound`."""
        return len(self._graphs)

    @property
    def graph_bound(self) -> int:
        """The most step signatures a run can need: one per ragged
        bucket with tile rows, and one more per bucket that can hold a
        step of one-query rows only (at most ``max_slots`` tokens)."""
        sch = self.scheduler
        buckets = sch.config.step_buckets()
        small = sch.ragged_bucket_for(min(sch.config.max_slots,
                                          buckets[-1]))
        return len(buckets) + sum(1 for b in buckets if b <= small)

    @property
    def pipeline_depth(self) -> int:
        """Dispatched-but-uncommitted steps in flight."""
        return len(self._inflight)

    def step(self) -> str:
        """Sweep deadlines, then plan and run one step: serially at
        depth 0, else through the pipeline (:meth:`_step_async`)."""
        self.scheduler.sweep_deadlines()
        if self.async_depth > 0:
            return self._step_async()
        plan = self.scheduler.step_plan(sweep=False)
        if plan.kind == "mixed":
            self._commit_step(self._prepare_step(plan))
        return plan.kind

    def _step_async(self) -> str:
        """One step at ``async_depth > 0``: plan and dispatch step N+1
        from the optimistic host state first (the device queues it
        behind N), THEN commit steps until at most ``async_depth`` are in
        flight. An idle plan with work in flight commits one step
        (reported as ``commit``), so the pipeline always drains."""
        self._refresh_async_hold()
        plan = self.scheduler.step_plan(sweep=False)
        kind = plan.kind
        if kind == "mixed":
            self._inflight.append(self._prepare_step(plan))
        committed = False
        limit = self.async_depth if kind == "mixed" else 0
        while len(self._inflight) > limit:
            self._commit_step(self._inflight.popleft())
            committed = True
            if kind != "mixed":
                break
        if kind == "mixed":
            occ = min(len(self._inflight), len(self.occupancy_hist) - 1)
            self.occupancy_hist[occ] += 1
        if kind == "idle" and committed:
            kind = "commit"
        return kind

    def _refresh_async_hold(self) -> None:
        """Slots the next plan must skip: one whose in-flight row is a
        verify row (how many tokens it lands is data-dependent, so the
        next row's sample positions are unknown until it commits), and
        one whose in-flight tokens exhaust ``max_new_tokens`` (a further
        row would be dead on arrival). Plain decode and final chunk rows
        land exactly one token, so their slots pipeline freely."""
        sch = self.scheduler
        hold = set()
        for stp in self._inflight:
            for r in stp.decode_rows:
                req = r.request
                if req.rid not in stp.dead and stp.drafts.get(req.slot):
                    hold.add(req.slot)
        for slot, req in sch.running.items():
            if (req.state == "running"
                    and len(req.output) + int(self._inflight_out[slot])
                    >= req.max_new_tokens):
                hold.add(slot)
        sch.async_hold = hold

    def _drain_pipeline(self) -> None:
        """Commit every in-flight step."""
        while self._inflight:
            self._commit_step(self._inflight.popleft())

    def _on_slot_teardown(self, req, slot: int, cause: str) -> None:
        """The scheduler's teardown hook: ``req`` leaves ``slot``
        (finish, cancel, timeout, preemption) and may still have rows in
        flight. Dead-mark them: their tokens are never landed, and the
        K/V they write is overwritten by the slot's next owner or masked
        by its ``kv_lens``; the release restores the pool."""
        for stp in self._inflight:
            if req.rid in stp.dead:
                continue
            if any(r.request is req for r in stp.plan.rows):
                stp.dead.add(req.rid)
                self.async_rollbacks += 1
                self.async_rollback_reasons[cause] = \
                    self.async_rollback_reasons.get(cause, 0) + 1
        self._inflight_out[slot] = 0
        self._carry_ok[slot] = False

    def run(self) -> None:
        while self.scheduler.has_work or self._inflight:
            if self.step() == "idle" and not self._inflight:
                break

    def output_of(self, rid: int) -> List[int]:
        return list(self.scheduler.finished[rid].output)

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens=16,
                 sampling: Optional[SamplingParams] = None) -> List[List[int]]:
        """Submit-all + run-to-completion. When admission rejects (queue
        full) it steps the engine and retries: backpressure shows as
        latency, never as an error."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        rids = []
        for p, mnt in zip(prompts, max_new_tokens):
            while True:
                try:
                    rids.append(self.submit(p, mnt, sampling))
                    break
                except QueueFull:
                    self.step()
        self.run()
        return [self.output_of(r) for r in rids]

    # ------------------------------------------------- unified mixed step --
    def _prepare_step(self, plan: Plan) -> _InFlight:
        """The dispatch half of one step: stage chunk contexts, collect
        drafts, pack the plan's rows into a flat ragged token block and
        dispatch it. At ``async_depth > 0`` the host state advances
        OPTIMISTICALLY here (prefill cursors, ``seq_lens``, in-flight
        token counts), so the next plan needs nothing of this step's
        results; a pipelined decode row reads its pending token from
        the device-resident carry."""
        sch = self.scheduler
        chunk_rows = [r for r in plan.rows if r.kind == "chunk"]
        decode_rows = [r for r in plan.rows if r.kind == "decode"]
        for r in chunk_rows:
            if r.first_chunk:
                # a resumed request's context is prompt + the output
                # before its preemption: it re-prefills like a prompt
                req = r.request
                ctx = req.kv_tokens()
                self._tok_matrix[req.slot, :] = 0
                self._tok_matrix[req.slot, :len(ctx)] = ctx
                self._row_len[req.slot] = len(ctx)
                self._inflight_out[req.slot] = 0
        drafts: Dict[int, List[int]] = {}
        if (decode_rows and sch.config.spec_tokens > 0
                and not sch.spec_suspended):
            budget = None
            if sch.config.step_token_budget > 0:
                # the budget bounds the step's total ragged tokens; the
                # chunk slice and one pending token per slot are packed
                # already, so drafts get what remains
                packed = (sum(r.chunk_len for r in chunk_rows)
                          + len(decode_rows))
                budget = max(sch.config.step_token_budget - packed, 0)
            drafts = self._collect_drafts(budget)
        asynch = self.async_depth > 0
        ms = sch.config.max_slots
        q_starts = np.zeros((ms,), np.int32)
        q_lens = np.zeros((ms,), np.int32)
        kv_lens = np.zeros((ms,), np.int32)
        flat_tokens: List[int] = []
        tok_src: List[int] = []
        seeds: List[int] = []
        sample_pos: List[int] = []
        temps: List[float] = []
        top_ks: List[int] = []
        top_ps: List[float] = []
        sample_idx: List[int] = []
        pre_lens: Dict[int, int] = {}    # decode rows: pre-step resident
        for r in plan.rows:
            req = r.request
            slot = req.slot
            sp = req.sampling or GREEDY
            if r.kind == "chunk":
                toks = req.kv_tokens()[r.start:r.start + r.chunk_len]
                src = [-1] * r.chunk_len
                ql = r.chunk_len
                kv = r.start + r.chunk_len
                # only the final position's sample is kept: output index
                # len(output) (0 for a fresh request, the key plain decode
                # would use for a resumed one)
                base = len(req.output) - (ql - 1)
                sample_idx.append(len(flat_tokens) + ql - 1)
            else:
                d = drafts.get(slot, [])
                toks = [int(self._tok_matrix[slot, self._row_len[slot] - 1])
                        ] + d
                # pipelined: the pending token is the previous step's
                # output, read from the carry when that entry is the
                # slot's true last token (the host value may be one
                # commit stale, and the step then ignores it)
                use_carry = asynch and bool(self._carry_ok[slot])
                src = ([slot] if use_carry else [-1]) + [-1] * len(d)
                ql = 1 + len(d)
                n0 = int(self.cache.seq_lens[slot])
                pre_lens[slot] = n0
                kv = n0 + ql
                # position t samples output index len(output) + t (+ the
                # tokens of the slot still in flight): the keys of ql
                # successive plain decode steps
                base = len(req.output) + int(self._inflight_out[slot])
                sample_idx.extend(range(len(flat_tokens),
                                        len(flat_tokens) + ql))
            q_starts[slot] = len(flat_tokens)
            q_lens[slot] = ql
            kv_lens[slot] = kv
            flat_tokens.extend(int(t) for t in toks)
            tok_src.extend(src)
            for t in range(ql):
                seeds.append(sp.seed or 0)
                sample_pos.append(base + t)
                temps.append(sp.temperature)
                top_ks.append(sp.top_k)
                top_ps.append(sp.top_p)
        n = len(flat_tokens)
        bucket = sch.ragged_bucket_for(n)
        ints = np.zeros((3 * ms + 5 * bucket + self._n_sample,), np.int32)
        ints[:3 * ms] = np.concatenate([q_starts, q_lens, kv_lens])
        tok_meta = ints[3 * ms:3 * ms + 5 * bucket].reshape(5, bucket)
        tok_meta[1, :] = -1                  # tok_src: host-fed tokens
        tok_meta[0, :n] = flat_tokens
        tok_meta[1, :n] = tok_src
        tok_meta[2, :n] = seeds
        tok_meta[3, :n] = sample_pos
        tok_meta[4, :n] = top_ks
        idx = ints[3 * ms + 5 * bucket:]
        idx[:] = bucket                      # the pad: read by nothing
        idx[:len(sample_idx)] = sample_idx
        floats = np.zeros((2 * bucket,), np.float32)
        floats[:n] = temps
        floats[bucket:bucket + n] = top_ps
        toks_h, ok_h, event = self._dispatch(bucket, ints, floats,
                                             int(q_lens.max()))
        self.steps_dispatched += 1
        stp = _InFlight(plan=plan, chunk_rows=chunk_rows,
                        decode_rows=decode_rows, drafts=drafts,
                        q_starts=q_starts, q_lens=q_lens, pre_lens=pre_lens,
                        toks=toks_h, ok=ok_h, event=event)
        if asynch:
            # optimistic host state: the next plan runs before commit
            for r in chunk_rows:
                req = r.request
                req.prefill_pos = r.start + r.chunk_len
                self.cache.seq_lens[req.slot] = max(
                    int(self.cache.seq_lens[req.slot]),
                    r.start + r.chunk_len)
                self._carry_ok[req.slot] = r.final_chunk
                if r.final_chunk:
                    # the request decodes from the next step on; its
                    # first token is in flight and the prefill lane is
                    # free for the next admission
                    req.state = "running"
                    self._inflight_out[req.slot] += 1
                    if sch._chunking is req:
                        sch._chunking = None
            for r in decode_rows:
                slot = r.request.slot
                if not drafts.get(slot):
                    # plain decode: one token in flight, one K/V entry
                    # written. A verify row's slot is held instead
                    self.cache.seq_lens[slot] = pre_lens[slot] + 1
                    self._inflight_out[slot] += 1
                    self._carry_ok[slot] = True
                else:
                    self._carry_ok[slot] = False
        return stp

    def _commit_step(self, stp: _InFlight) -> None:
        """The landing half of one step, one step behind its dispatch
        under pipelining: wait for its results, check the live rows'
        logits, then land them; rows dead-marked since dispatch are
        skipped. The JAX engine quarantines a row with non-finite
        logits; until the port's device-fault slice brings that, such a
        row stops the engine."""
        if stp.event is not None:
            stp.event.synchronize()
        toks, ok = stp.toks, stp.ok
        self.steps_committed += 1
        bad = [r.request.rid for r in stp.plan.rows
               if r.request.rid not in stp.dead
               and not ok[stp.q_starts[r.request.slot]:
                          stp.q_starts[r.request.slot]
                          + stp.q_lens[r.request.slot]].all()]
        if bad:
            raise FloatingPointError(
                f"non-finite logits in the rows of requests {bad}")
        self._land_step(stp, toks)

    def _land_step(self, stp: _InFlight, toks: np.ndarray) -> None:
        """Land every live row: chunk cursor advances, prefill
        completions (first tokens), decode and verify tokens."""
        sch = self.scheduler
        q_starts, q_lens = stp.q_starts, stp.q_lens
        chunk_rows = [r for r in stp.chunk_rows
                      if r.request.rid not in stp.dead]
        decode_rows = [r for r in stp.decode_rows
                       if r.request.rid not in stp.dead]
        if self.async_depth > 0:
            # this step's pending tokens land now: the optimistic counts
            # fold back down
            for r in chunk_rows:
                if r.final_chunk:
                    slot = r.request.slot
                    self._inflight_out[slot] = max(
                        0, int(self._inflight_out[slot]) - 1)
            for r in decode_rows:
                slot = r.request.slot
                if not stp.drafts.get(slot):
                    self._inflight_out[slot] = max(
                        0, int(self._inflight_out[slot]) - 1)
        for r in chunk_rows:
            req = r.request
            slot = req.slot
            if not r.final_chunk:
                sch.on_chunk_done(req, r)
                continue
            first = int(toks[q_starts[slot] + q_lens[slot] - 1])
            sch.on_chunk_done(req, r, first, self.eos_id)
            if req.state != "finished":
                self._tok_matrix[slot, self._row_len[slot]] = first
                self._row_len[slot] += 1
        self._land_verify_rows(decode_rows, stp.drafts, q_starts,
                               stp.pre_lens, toks)

    def _land_verify_rows(self, decode_rows: List[RowPlan],
                          drafts: Dict[int, List[int]], q_starts, pre_lens,
                          toks) -> None:
        """Land the decode and verify rows: per slot, accept the longest
        draft prefix that matches the target's samples and emit the
        accepted drafts plus one more token (the bonus on full
        acceptance, the corrected target on a mismatch; a draftless row
        emits its one token). The rejected tail's K/V is rolled back with
        ``cache.truncate`` under the request's reserve floor. An EOS
        inside a block stops delivery at the EOS. A step in which any
        slot drafted counts in the ``n_spec_*`` stats."""
        sch = self.scheduler
        emitted: Dict[int, List[int]] = {}
        n_active = n_drafted = n_accepted = 0
        for r in decode_rows:
            req = r.request
            slot = req.slot
            n_active += 1
            draft = drafts.get(slot, [])
            k = len(draft)
            qs = int(q_starts[slot])
            out: List[int] = []
            acc = 0
            for i in range(k):
                t = int(toks[qs + i])
                out.append(t)          # the target's token, always kept
                if t != draft[i]:
                    break
                acc += 1
            if acc == k:               # full acceptance: the bonus token
                out.append(int(toks[qs + k]))
            # positions n0 .. n0 + k were written; those past 1 + acc
            # hold rejected drafts. max: a later pipelined step may have
            # advanced a draftless slot already
            n0 = pre_lens[slot]
            self.cache.seq_lens[slot] = max(int(self.cache.seq_lens[slot]),
                                            n0 + 1 + k)
            if k - acc:
                self.cache.truncate(
                    slot, k - acc,
                    reserve_tokens=len(req.prompt) + req.max_new_tokens)
            emitted[slot] = out
            if k:
                n_drafted += k
                n_accepted += acc
                self._adapt_spec_len(req, k, acc)
        delivered = sch.on_verify_done(emitted, self.eos_id)
        if drafts:
            sch.stats["n_spec_steps"] += 1
            sch.stats["n_spec_slot_steps"] += n_active
            sch.stats["n_spec_drafted"] += n_drafted
            sch.stats["n_spec_accepted"] += n_accepted
            sch.stats["n_spec_emitted"] += sum(delivered.values())
        # each still-running slot's landed tokens join its host context
        # (the next pending token and the drafter's input)
        for r in decode_rows:
            req = r.request
            if req.state == "running":
                out = emitted[req.slot]
                rl = self._row_len[req.slot]
                self._tok_matrix[req.slot, rl:rl + len(out)] = out
                self._row_len[req.slot] += len(out)

    # ----------------------------------------------- speculative drafting --
    def _collect_drafts(self, budget: Optional[int] = None
                        ) -> Dict[int, List[int]]:
        """n-gram drafts for every decoding slot that has budget and a
        match (slot -> draft tokens). A draft is capped at ``remaining -
        1`` tokens (the tokens of the slot still in flight counted), so
        the verify row never overruns ``max_new_tokens`` or the reserved
        pages, and at the step budget's remainder when one is given."""
        cfg = self.scheduler.config
        drafts: Dict[int, List[int]] = {}
        left = budget
        for slot, req in sorted(self.scheduler.running.items()):
            if req.state != "running":
                continue
            if req.spec_len <= 0:
                # speculation turned itself off for this request; probe
                # again after a quiet stretch
                req.spec_idle += 1
                if req.spec_idle >= SPEC_PROBE_EVERY:
                    req.spec_idle = 0
                    req.spec_len = 1
                    req.spec_window.clear()
                continue
            remaining = (req.max_new_tokens - len(req.output)
                         - int(self._inflight_out[slot]))
            cap = min(req.spec_len, cfg.spec_tokens, remaining - 1)
            if left is not None:
                cap = min(cap, left)
            if cap <= 0:
                continue
            draft = ngram_draft(self._tok_matrix[slot, :self._row_len[slot]],
                                cap)
            if draft:
                drafts[slot] = draft
                if left is not None:
                    left -= len(draft)
        return drafts

    def _adapt_spec_len(self, req, drafted: int, accepted: int) -> None:
        """Windowed acceptance controller: a window acceptance below
        ``SPEC_DECAY_BELOW`` shrinks the request's draft budget (down to
        0, plain decode), one at or above ``SPEC_GROW_ABOVE`` grows it
        back toward ``spec_tokens``."""
        req.spec_drafted += drafted
        req.spec_accepted += accepted
        req.spec_window.append((drafted, accepted))
        if len(req.spec_window) > SPEC_WINDOW:
            del req.spec_window[0]
        d = sum(w[0] for w in req.spec_window)
        a = sum(w[1] for w in req.spec_window)
        ratio = a / d if d else 0.0
        if ratio < SPEC_DECAY_BELOW:
            req.spec_len = max(req.spec_len - 1, 0)
            req.spec_idle = 0
        elif ratio >= SPEC_GROW_ABOVE:
            req.spec_len = min(req.spec_len + 1,
                               self.scheduler.config.spec_tokens)

    # ---------------------------------------------------- step dispatch --
    def _dispatch(self, bucket: int, ints: np.ndarray, floats: np.ndarray,
                  max_q: int):
        """Run one step and start its results on their way to the host;
        returns ``(toks, ok, event)`` (``event`` None on the CPU, where
        the step has run by the time this returns).

        The step's signature is ``("step", bucket, tile rows)``: whether
        a row has more than one query decides whether the ragged kernel
        launches its tile kernel at all. On the card the metadata goes
        to the bucket's static device inputs from a ring of pinned host
        buffers (``async_depth + 2`` entries, so an entry is rewritten
        only after the step that used it has committed), and the
        outputs come back into the same entry, followed by its event.
        With CUDA graphs, a signature's first step runs eagerly and
        then captures the step into one graph (every bucket's graph in
        one shared memory pool; the tile grid sized to the whole bucket,
        whose extra blocks exit at once); each later step of that
        signature replays it. The copies out of a replay are queued
        right behind it, before any other replay can reuse the pool's
        memory."""
        tiles = max_q > DECODE_MAX_Q
        key = ("step", bucket, tiles)
        self.steps_by_class["mix" if tiles else "decode"] += 1
        levels = self._device_page_levels()
        if self.device.type != "cuda":
            self._graphs.setdefault(key, None)
            toks, ok = self._run_step(
                bucket, torch.from_numpy(ints), torch.from_numpy(floats),
                max_q, levels)
            return toks.numpy(), ok.numpy(), None
        slot = self._ring_slot()
        slot.ints[:len(ints)].numpy()[:] = ints
        slot.floats[:len(floats)].numpy()[:] = floats
        ints_d, floats_d = self._bucket_inputs(bucket, len(ints),
                                               len(floats))
        ints_d.copy_(slot.ints[:len(ints)], non_blocking=True)
        floats_d.copy_(slot.floats[:len(floats)], non_blocking=True)
        graph = self._graphs.get(key)
        if graph is not None:
            graph.graph.replay()
            pa.LAUNCHES.update(graph.held)
            toks, ok = graph.toks, graph.ok
        elif not self.cuda_graphs:
            self._graphs[key] = None
            toks, ok = self._run_step(bucket, ints_d, floats_d, max_q,
                                      levels)
        else:
            grid_q = bucket if tiles else max_q
            toks, ok = self._run_step(bucket, ints_d, floats_d, grid_q,
                                      levels)
            self._graphs[key] = self._capture(bucket, ints_d, floats_d,
                                              grid_q, levels)
        slot.toks[:bucket].copy_(toks, non_blocking=True)
        slot.ok[:bucket].copy_(ok, non_blocking=True)
        slot.event.record()
        return (slot.toks[:bucket].numpy(), slot.ok[:bucket].numpy(),
                slot.event)

    def _run_step(self, bucket, ints, floats, max_q, levels):
        return _step(self.model, self.cache, levels, ints, floats,
                     self._carry_d, bucket, self._attn_tier,
                     max_q_len=max_q, quant=self.quant,
                     kv_split_pages=self._kv_split_pages)

    def _capture(self, bucket, ints_d, floats_d, max_q,
                 levels) -> _StepGraph:
        """Capture the step of ``bucket`` over its static inputs into a
        CUDA graph (nothing runs). Raises if the capture fails."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a collected graph (an
        # earlier engine's) would be destroyed mid-capture, which the
        # driver refuses and which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with pa.held_launches() as held:
                with torch.cuda.graph(graph, pool=self._graph_pool):
                    toks, ok = self._run_step(bucket, ints_d, floats_d,
                                              max_q, levels)
        finally:
            if collecting:
                gc.enable()
        return _StepGraph(graph=graph, toks=toks, ok=ok, held=held)

    def _ring_slot(self) -> _Slot:
        """The next pinned ring entry, once the step that used it last
        has finished with it."""
        if not self._ring:
            cfg = self.scheduler.config
            width = cfg.step_buckets()[-1]
            n_int = 3 * cfg.max_slots + 5 * width + self._n_sample
            for _ in range(self.async_depth + 2):
                self._ring.append(_Slot(
                    ints=torch.empty((n_int,), dtype=torch.int32,
                                     pin_memory=True),
                    floats=torch.empty((2 * width,), dtype=torch.float32,
                                       pin_memory=True),
                    toks=torch.empty((width,), dtype=torch.int32,
                                     pin_memory=True),
                    ok=torch.empty((width,), dtype=torch.bool,
                                   pin_memory=True),
                    event=torch.cuda.Event()))
        slot = self._ring[self._ring_next % len(self._ring)]
        self._ring_next += 1
        slot.event.synchronize()
        return slot

    def _bucket_inputs(self, bucket: int, n_int: int, n_float: int):
        """The static device inputs of ``bucket``'s steps (a graph reads
        them where they lie)."""
        if bucket not in self._inputs_dev:
            self._inputs_dev[bucket] = (
                torch.empty((n_int,), dtype=torch.int32, device=self.device),
                torch.empty((n_float,), dtype=torch.float32,
                            device=self.device))
        return self._inputs_dev[bucket]

    def _device_page_levels(self):
        """The device copy of the two-level page table, rewritten in
        place (queued behind the steps in flight, which read the old
        table first) only when the host table changed."""
        if self._levels_version != self.cache.page_table_version:
            for dst, src in zip(self._levels_dev, (self.cache.slot_dir,
                                                   self.cache.index_pool)):
                host = torch.from_numpy(src)
                if self.device.type == "cuda":
                    dst.copy_(host.pin_memory(), non_blocking=True)
                else:
                    dst.copy_(host)
            self._levels_version = self.cache.page_table_version
            self.pt_uploads += 1
        return self._levels_dev
