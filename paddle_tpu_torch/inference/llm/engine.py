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
(see ``scheduler.py``); the host swap tier is the cache's.

Observability, as the JAX engine wires it: every step is decomposed
into the step profiler's host phases (``stepprof``), the device's busy
and idle time of each step come from CUDA events recorded on the
engine's stream around its device work (never inside a captured
graph), the serving counters and the flight recorder see every step
and request, the cost ledger (``ledger``) models each landed step's
bytes and FLOPs per tenant, and each graph capture is timed into its
compile observatory. ``request_summary`` reconstructs one request's
latency breakdown.

Robustness: the crash-safe ``journal`` (``submit`` and the scheduler
append to it; ``restore`` replays it into a fresh engine bit-exactly,
``drain`` stops admission and checkpoints), the fault injector
(``faults.py``: a kill at a step, delays, NaN rows, dispatch faults),
the brownout controller (``brownout.py``, ticked before every plan),
and the device-fault boundary: an injected dispatch fault is retried
once; at depth 0 a step with rows whose logits read non-finite runs
once more, whole, on the engine's own route (the kernels); what is
still poisoned (at depth > 0 at once, as in the JAX engine) ends
``device_fault`` with its pages scrubbed and restored, and the engine
serves on. No step is ever served from another route: a real exception
from a step (a kernel that fails to build or launch, a sticky CUDA
error) propagates.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import os
import time
import weakref
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...kernels import paged_attention as pa
from ...kernels.paged_attention import DECODE_MAX_Q
from ...observability import serving_metrics
from ...observability.ledger import StepLedger
from ...observability.metrics import default_registry
from ...observability.recorder import default_recorder
from ...observability.stepprof import StepProfiler
from ...observability.tracing import instrument_jit
from .brownout import BrownoutController
from .faults import EngineKilled, default_injector
from .journal import RequestJournal, read_journal
from .kv_cache import CacheConfig, PagedKVCache, flatten_page_levels
from .model import TorchLM, lm_ragged_step, resolve_carry_tokens, step_carry
from .policy import (SPEC_DECAY_BELOW, SPEC_GROW_ABOVE, SPEC_NGRAM_MAX,
                     SPEC_NGRAM_MIN, SPEC_PROBE_EVERY, SPEC_WINDOW)
from .quant import QuantConfig
from .scheduler import (ContinuousBatchingScheduler, Plan, QueueFull,
                        Request, RowPlan, SchedulerConfig)
from .threefry import categorical, fold_in, prng_key

__all__ = ["SamplingParams", "GREEDY", "resolve_sampling", "ngram_draft",
           "GenerationEngine", "GraphCaptureError"]


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


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture of a step failed. The device-fault boundary
    never retries it: there is no eager fallback for a capture."""


class _InjectedFault(RuntimeError):
    """The fault injector's dispatch fault (``PD_FAULT_DISPATCH_RATE``)."""


# CUDA errors after which the context is unusable: nothing launched
# after them can succeed, so the fault boundary lets them propagate
_STICKY_CUDA = ("illegal memory access", "unspecified launch failure",
                "misaligned address", "illegal instruction",
                "device-side assert", "launch timed out",
                "uncorrectable ECC", "hardware stack error",
                "unknown error")


def _sticky_cuda_error(err: BaseException) -> bool:
    msg = str(err)
    return any(k in msg for k in _STICKY_CUDA)


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
    staged metadata, its outputs copied back, the event recorded after
    those copies (``event``) and, while the step profiler is on, the
    one recorded before the step's input copies (``start``); both time
    the step's device span."""
    ints: torch.Tensor
    floats: torch.Tensor
    toks: torch.Tensor
    ok: torch.Tensor
    event: object
    start: object


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
    # the packed step (the depth-0 retry runs it again), its bucket,
    # ragged tokens and the host clock at dispatch
    ints: Optional[np.ndarray] = None
    floats: Optional[np.ndarray] = None
    bucket: int = 0
    n_ragged: int = 0
    t0: float = 0.0
    # the device span: start/end events on the card (the previous
    # step's end event beside them), host clock on the CPU; the step
    # profiler's sample flag and the pipeline occupancy at dispatch
    t_done: float = 0.0
    start_ev: object = None
    prev_end: object = None
    fence: bool = False
    fence_s: Optional[float] = None
    depth: int = 0
    # the dispatch needed the fault boundary's one retry
    retried: bool = False


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
    capture that fails raises :class:`GraphCaptureError`: there is no
    eager fallback. ``journal`` (a :class:`RequestJournal`) makes the
    engine's requests durable (see :meth:`restore`)."""

    def __init__(self, model: TorchLM,
                 cache_config: Optional[CacheConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 eos_id: Optional[int] = None, attn_tier: str = "auto",
                 quant: Optional[QuantConfig] = None, device=None,
                 cuda_graphs: Optional[bool] = None,
                 journal: Optional[RequestJournal] = None):
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
        # ---- observability ----
        # registry handles bound once; the labelled families' known
        # series pre-bound so an export shows them at zero
        self.obs_registry = default_registry()
        self._obs = serving_metrics()
        for _kind in ("chunk", "decode", "verify"):
            self._obs["mixed_rows"].labels(kind=_kind)
        for _cause in self.async_rollback_reasons:
            self._obs["async_rollbacks"].labels(reason=_cause)
        for _kind in ("nan", "dispatch"):
            self._obs["fault_retries"].labels(kind=_kind)
        self._obs["async_depth"].set(self.async_depth)
        self._obs["kv_quant_mode"].set(
            {"off": 0, "int8": 1, "fp8": 2}[
                self.quant.kv if self.quant is not None else "off"])
        self._obs["kv_page_bytes"].set(float(self.cache.config.page_bytes()))
        self._rec = default_recorder()
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        # the step-phase profiler; under pipelining its idle accounting
        # is the device-side gap between consecutive steps
        self.stepprof = StepProfiler()
        self.stepprof.set_overlap(self.async_depth > 0)
        # the previous dispatched step's end event (the card): the gap
        # to the next step's start event is the device's idle time
        self._prev_end = None
        # the step functions, observed: eager launches and graph
        # replays (pd_jit_call_seconds{graph}; the compile family is
        # counted once, per step signature, by _note_signature); they
        # hold the engine weakly, as the teardown hook does (a cycle
        # would keep a dropped engine's pools and graphs on the card
        # until a collection)
        ref = weakref.ref(self)
        self._eager_fn = instrument_jit(
            lambda *args: ref()._run_step(*args), "step_eager",
            count_compiles=False)
        self._replay_fn = instrument_jit(lambda key: ref()._replay(key),
                                         "step_replay", count_compiles=False)
        # ---- robustness ----
        # fault injection (inert by default) and PD_KV_CHECK: with it
        # on, every step ends with the pool's accounting audit
        self._faults = default_injector()
        self._kv_check = os.environ.get(
            "PD_KV_CHECK", "0").lower() not in ("0", "false", "off", "")
        # the device-fault boundary's retries by kind: rows re-run after
        # non-finite logits, steps re-dispatched after a dispatch fault
        self.fault_retries = {"nan": 0, "dispatch": 0}
        # the crash-safe request journal (optional): submits land here,
        # the scheduler appends delivered tokens and terminal reasons
        self.journal = journal
        self.scheduler.journal = journal
        # overload brownout: inert (one branch per step) unless
        # SchedulerConfig.brownout_levels > 0
        self.brownout = BrownoutController(self)
        # the cost ledger & compile observatory (PD_COST_LEDGER, default
        # on); None = off, one branch per step
        ledger_on = os.environ.get(
            "PD_COST_LEDGER", "1").lower() not in ("0", "false", "off", "")
        self.ledger: Optional[StepLedger] = (
            StepLedger.for_engine(self) if ledger_on else None)

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
        rid = self.scheduler.submit(prompt, max_new_tokens, sp,
                                    priority=priority, tenant=tenant,
                                    ttft_deadline_s=ttft_deadline_s,
                                    deadline_s=deadline_s)
        if self.journal is not None:
            # the RESOLVED sampling (concrete seed): a replay re-draws
            # nothing
            self.journal.record_submit(rid, prompt, max_new_tokens, sp,
                                       priority=priority, tenant=tenant,
                                       ttft_deadline_s=ttft_deadline_s,
                                       deadline_s=deadline_s)
        return rid

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
        """One engine step: the injected kill and delay (chaos only),
        the deadline sweep, the brownout controller's tick, then plan
        and run the step serially at depth 0, else through the pipeline
        (:meth:`_step_async`); each part lapped into the step
        profiler's phases."""
        if self._faults.should_kill():   # chaos: simulated process death
            raise EngineKilled(
                f"injected kill at step {self._faults.counts['kill_probe']}"
                " (PD_FAULT_KILL_STEP)")
        prof = self.stepprof
        prof.begin_step()
        delay = self._faults.step_delay_s()
        if delay > 0.0:
            # an injected stall lands in its own phase, never in
            # device_wait or the device-idle accounting
            time.sleep(delay)
            prof.lap("fault_delay")
        self.scheduler.sweep_deadlines()
        prof.lap("deadline_sweep")
        # brownout feedback: evaluate pressure and (at the shed level)
        # shed queued low-priority work BEFORE planning admits anyone
        self.brownout.tick()
        committed = self.steps_committed
        if self.async_depth > 0:
            kind = self._step_async()
        else:
            plan = self.scheduler.step_plan(sweep=False)
            prof.lap("plan")
            if plan.kind == "mixed":
                stp = self._prepare_step(plan)
                if stp is not None:
                    self._commit_step(stp)
            kind = plan.kind
        prof.annotate(commits=self.steps_committed - committed)
        if self._kv_check:
            self.cache.check_invariants()
        prof.lap("page_bookkeeping")
        prof.end_step(kind)
        return kind

    def _step_async(self) -> str:
        """One step at ``async_depth > 0``: plan and dispatch step N+1
        from the optimistic host state first (the device queues it
        behind N), THEN commit steps until at most ``async_depth`` are in
        flight. An idle plan with work in flight commits one step
        (reported as ``commit``), so the pipeline always drains."""
        self._refresh_async_hold()
        plan = self.scheduler.step_plan(sweep=False)
        self.stepprof.lap("plan")
        kind = plan.kind
        if kind == "mixed":
            stp = self._prepare_step(plan)
            if stp is not None:
                self._inflight.append(stp)
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
                self._obs["async_rollbacks"].labels(reason=cause).inc()
                self._rec.emit("engine", "async_rollback", rid=req.rid,
                               slot=slot, reason=cause)
        self._inflight_out[slot] = 0
        self._carry_ok[slot] = False

    def run(self) -> None:
        while self.scheduler.has_work or self._inflight:
            if self.step() == "idle" and not self._inflight:
                break

    def output_of(self, rid: int) -> List[int]:
        return list(self.scheduler.finished[rid].output)

    # ------------------------------------------------ drain / hot restart --
    def drain(self, finish_residents: bool = False,
              max_steps: int = 10000) -> List[int]:
        """Graceful shutdown: stop admission, then either PREEMPT every
        resident request back to its queue (default: their journaled
        state restores them after a restart) or keep stepping until
        residents finish (``finish_residents=True``), land every step
        in flight, and flush + fsync the journal. Returns the rids still
        live (unfinished) at drain — what ``restore`` of this journal
        would resubmit."""
        sch = self.scheduler
        sch.admission_paused = True
        if finish_residents:
            steps = 0
            while (sch.running or self._inflight) and steps < max_steps:
                self.step()
                steps += 1
        # residents are evicted from fully committed state: their
        # journaled token streams end at a record boundary
        self._drain_pipeline()
        for req in list(sch.running.values()):
            sch.preempt_request(req, reason="drain", requeue=True)
        if self.journal is not None:
            self.journal.flush(sync=True)
        live = [r.rid for r in sch.waiting]
        self._rec.emit("engine", "drained", live=len(live),
                       journaled=self.journal is not None)
        return live

    def restore(self, journal) -> Dict[int, int]:
        """Hot restart: re-submit every UNFINISHED request of
        ``journal`` (a path, a :class:`RequestJournal`, or a replayed
        entry dict — the JAX package's journals included, the format
        is shared) into this engine with its original seed, priority,
        tenant and deadlines, pre-loading the tokens it had been
        delivered. It resumes through the re-prefill path a preemption
        uses, so its remaining output is bit-exact with the
        uninterrupted run (sampling is a pure function of (seed, token
        index)). The last journaled token of each request is
        regenerated, not replayed, so the EOS / ``max_new_tokens``
        logic fires as it would have. Returns {old rid -> new rid}."""
        if isinstance(journal, RequestJournal):
            entries = journal.replay()
        elif isinstance(journal, dict):
            entries = journal
        else:
            entries = read_journal(str(journal))
        mapping: Dict[int, int] = {}
        for old_rid in sorted(entries):
            e = entries[old_rid]
            if e.finish_reason is not None:
                continue
            sp = SamplingParams(temperature=e.temperature, top_k=e.top_k,
                                top_p=e.top_p, seed=e.seed)
            rid = self.submit(e.prompt, e.max_new_tokens, sp,
                              priority=e.priority, tenant=e.tenant,
                              ttft_deadline_s=e.ttft_deadline_s,
                              deadline_s=e.deadline_s)
            replay = list(e.tokens[:-1]) if e.tokens else []
            if replay:
                req = self.scheduler.requests[rid]
                req.output.extend(replay)
                req.restored_tokens = len(replay)
                if self.journal is not None:
                    # a SECOND crash must still see these tokens
                    self.journal.record_tokens(rid, replay)
            mapping[old_rid] = rid
            self._rec.emit("request", "restore_from_journal", rid=rid,
                           old_rid=old_rid, replayed=len(replay))
        if self.journal is not None:
            self.journal.flush(sync=True)
        return mapping

    # ------------------------------------------------- request tracing --
    def request_summary(self, rid: int) -> dict:
        """Latency breakdown of one request (any state), from its
        lifecycle timestamps: queue wait, TTFT, decode time, the
        inter-token-latency percentiles of its newest tokens, tokens,
        pages and the cost ledger's bytes and FLOPs. The flight
        recorder's ``events_for(rid)`` holds the full timeline."""
        req = self.scheduler.requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        now = time.perf_counter()
        itl_p50 = itl_p99 = None
        if len(req.token_times) >= 2:
            gaps = np.diff(np.asarray(req.token_times,
                                      dtype=np.float64)) * 1e3
            itl_p50 = float(np.percentile(gaps, 50))
            itl_p99 = float(np.percentile(gaps, 99))
        return {
            "rid": rid,
            "state": req.state,
            "slot": req.slot,
            "prompt_len": len(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "tokens_generated": len(req.output),
            "pages_reserved": req.pages_reserved,
            "cached_prefix_tokens": req.prefix_len,
            "prefill_chunks": req.prefill_chunks,
            "priority": req.priority,
            "tenant": req.tenant,
            "preemptions": req.preemptions,
            "restored_tokens": req.restored_tokens,
            "finish_reason": req.finish_reason or None,
            "retry_after_s": req.retry_after_s or None,
            "age_seconds": now - req.t_submit,
            "queue_wait_seconds": ((req.t_admit or now) - req.t_submit),
            "ttft_seconds": ((req.t_first_token - req.t_submit)
                             if req.t_first_token else None),
            "decode_seconds": (((req.t_finish or now) - req.t_first_token)
                               if req.t_first_token else None),
            "itl_p50_ms": itl_p50,
            "itl_p99_ms": itl_p99,
            "spec_drafted": req.spec_drafted,
            "spec_accepted": req.spec_accepted,
            "cost_hbm_bytes": req.cost_hbm_bytes,
            "cost_flops": req.cost_flops,
            "cost_hbm_bytes_per_token": (
                req.cost_hbm_bytes / len(req.output)
                if req.output else None),
            "cost_flops_per_token": (
                req.cost_flops / len(req.output)
                if req.output else None),
        }

    def request_summaries(self) -> Dict[int, dict]:
        """Summaries of every request this engine has seen."""
        return {rid: self.request_summary(rid)
                for rid in list(self.scheduler.requests)}

    def reset_step_profile(self) -> None:
        """A fresh step profiler (records, phase and device totals) and
        a fresh device-gap chain, for a measurement that starts now."""
        self.stepprof = StepProfiler()
        self.stepprof.set_overlap(self.async_depth > 0)
        self._prev_end = None

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
                req.t_prefill_start = time.perf_counter()
        prof = self.stepprof
        prof.lap("plan")           # chunk-row context staging above
        drafts: Dict[int, List[int]] = {}
        if (decode_rows and sch.config.spec_tokens > 0
                and not sch.spec_suspended):
            budget = None
            eff_budget = sch.effective_step_budget()
            if eff_budget > 0:
                # the budget bounds the step's total ragged tokens; the
                # chunk slice and one pending token per slot are packed
                # already, so drafts get what remains
                packed = (sum(r.chunk_len for r in chunk_rows)
                          + len(decode_rows))
                budget = max(eff_budget - packed, 0)
            drafts = self._collect_drafts(budget)
        prof.lap("draft")
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
        prof.lap("pack")
        stp = _InFlight(plan=plan, chunk_rows=chunk_rows,
                        decode_rows=decode_rows, drafts=drafts,
                        q_starts=q_starts, q_lens=q_lens, pre_lens=pre_lens,
                        toks=None, ok=None, ints=ints, floats=floats,
                        bucket=bucket, n_ragged=n, fence=prof.fence,
                        depth=len(self._inflight))
        if not self._guarded_dispatch(stp, int(q_lens.max())):
            # both attempts failed: every row's request is quarantined
            # (pages restored); the step lands nothing, the engine lives
            prof.annotate(tokens=n, bucket=bucket, tokens_out=0)
            prof.lap("sample_commit")
            return None
        self.steps_dispatched += 1
        prof.lap("dispatch")
        prof.annotate(tokens=n, bucket=bucket)
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
        under pipelining: wait for its results (the device-fault
        boundary's materialize side), report its device span to the
        step profiler, scan the live rows for non-finite logits (and
        injected NaN rows), retry a poisoned step once at depth 0
        (:meth:`_retry_step`) and quarantine what stays poisoned, then
        land the rest. Rows dead-marked since dispatch are skipped."""
        prof = self.stepprof
        if stp.event is not None:
            try:
                stp.event.synchronize()
            except EngineKilled:
                raise
            except Exception as e:     # noqa: BLE001 — the fault boundary
                if _sticky_cuda_error(e):
                    raise
                prof.lap("device_wait")
                self.steps_committed += 1
                self._async_step_failed(stp, e)
                prof.lap("sample_commit")
                return
        prof.lap("device_wait")
        self._observe_device(stp)
        self.steps_committed += 1
        toks, ok = stp.toks, stp.ok
        live = [r for r in stp.plan.rows if r.request.rid not in stp.dead]
        bad, injected = self._scan_poisoned_rows(live, stp.q_starts,
                                                 stp.q_lens, ok)
        if bad or injected:
            poisoned = bad | injected
            if not stp.retried:
                # one retry per step: a step whose dispatch was retried
                # already quarantines its poisoned rows at once
                self._note_retry("nan", stp.bucket, len(poisoned))
                if self.async_depth == 0:
                    poisoned, toks = self._retry_step(stp, live)
            if poisoned is None:
                # the retry's own dispatch failed: the step is
                # unrunnable, every live row is quarantined
                self._quarantine_failed_step(
                    {r.request.rid: r.request for r in live}, stp.bucket,
                    _InjectedFault("injected dispatch fault on the retry "
                                   "(PD_FAULT_DISPATCH_RATE)"))
                stp.dead.update(r.request.rid for r in live)
                poisoned = ()
            for r in live:
                req = r.request
                if req.slot not in poisoned:
                    continue
                # page hygiene before the teardown: the poisoned row's
                # NaN K/V must not survive into the pages' next owner
                self.cache.scrub_slot(req.slot)
                self.scheduler.fault_terminate(req, kind="nan")
                stp.dead.add(req.rid)
        self._land_step(stp, toks)

    def _observe_device(self, stp: _InFlight) -> None:
        """Report a committed step's device span to the step profiler
        (busy, and the idle gap since the previous step), and on
        sampled steps its span into the step record."""
        prof = self.stepprof
        if stp.start_ev is not None:
            busy = stp.start_ev.elapsed_time(stp.event) / 1e3
            gap = (stp.prev_end.elapsed_time(stp.start_ev) / 1e3
                   if stp.prev_end is not None else None)
            prof.device_span(gap, busy, stp.depth)
        elif stp.event is None and stp.t_done:
            busy = stp.t_done - stp.t0
            prof.device_gap(stp.t0, stp.t_done, stp.depth)
        else:
            return
        if stp.fence:
            prof.device(stp.t0, busy)
            stp.fence_s = busy

    # ------------------------------------------------ device-fault boundary --
    def _guarded_dispatch(self, stp: _InFlight, max_q: int) -> bool:
        """The device-fault boundary around one step's dispatch. Only an
        injected dispatch fault (``PD_FAULT_DISPATCH_RATE``) is retried:
        once, on the engine's own route, at depth 0 after the injector
        is rolled again as the JAX engine's retry rolls it. At depth > 0
        the JAX engine quarantines without a retry, so the fault
        persists and both engines end the same requests
        ``device_fault``. A step still faulted has every row's request
        quarantined and returns False. A real exception from the step
        propagates: no step is served from another route, so a kernel
        that fails to build or launch stops the engine."""
        inj = self._faults
        if not inj.dispatch_fault():
            self._dispatch(stp, max_q)
            return True
        err = _InjectedFault("injected dispatch fault "
                             "(PD_FAULT_DISPATCH_RATE)")
        self.stepprof.lap("dispatch")           # the failed attempt
        self._note_retry("dispatch", stp.bucket, 1, err)
        if self.async_depth == 0 and not inj.dispatch_fault():
            self._dispatch(stp, max_q)
            stp.retried = True
            return True
        self._quarantine_failed_step(
            {r.request.rid: r.request for r in stp.plan.rows}, stp.bucket,
            err)
        return False

    def _note_retry(self, kind: str, bucket: int, n: int,
                    err: Optional[BaseException] = None) -> None:
        """Count and record one retry of the fault boundary: ``n`` rows
        (kind ``nan``) or one step (kind ``dispatch``). At depth > 0 a
        retry is recorded but not run: the rows are quarantined."""
        self.fault_retries[kind] += n
        self._obs["fault_retries"].labels(kind=kind).inc(n)
        self._rec.emit("engine", "device_fault_retry", kind=kind,
                       bucket=bucket, rows=n,
                       error=str(err)[:200] if err is not None else "")

    def _scan_poisoned_rows(self, rows: List[RowPlan], q_starts, q_lens,
                            ok) -> Tuple[set, set]:
        """Slots of ``rows`` whose logits read non-finite anywhere in the
        row, and slots the injector poisons (``PD_FAULT_NAN_RATE``; a
        row already non-finite rolls nothing, as on the JAX side)."""
        inj = self._faults
        inject = inj.config.nan_rate > 0
        bad, injected = set(), set()
        for r in rows:
            slot = r.request.slot
            qs, ql = int(q_starts[slot]), int(q_lens[slot])
            if not bool(ok[qs:qs + ql].all()):
                bad.add(slot)
            elif inject and inj.nan_row(r.request.rid):
                injected.add(slot)
        return bad, injected

    def _retry_step(self, stp: _InFlight, live: List[RowPlan]):
        """Depth 0, as the JAX engine's retry: the injector's dispatch
        fault is rolled first (a hit makes the step unrunnable: returns
        ``(None, toks)``), then the whole step runs once more on the
        engine's own route from the same in-place pools (its scatters
        are idempotent: the same positions get the same values, and at
        depth 0 no row reads the carry), and every live row is scanned
        again with the injector rolled again. Returns (poisoned slots,
        the retry's tokens)."""
        if self._faults.dispatch_fault():
            return None, stp.toks
        self._dispatch(stp, int(stp.q_lens.max()), retry=True)
        if stp.event is not None:
            stp.event.synchronize()
        bad, injected = self._scan_poisoned_rows(live, stp.q_starts,
                                                 stp.q_lens, stp.ok)
        return bad | injected, stp.toks

    def _quarantine_failed_step(self, victims: Dict[int, Request],
                                bucket: int, err) -> None:
        """Shared tail of every unrunnable-step path (both dispatch
        attempts failed; a pipelined step whose results failed to
        arrive): terminate the affected requests ``device_fault`` with
        their pages restored. The port's pools are written in place,
        never consumed by a failed step, so no pool is rebuilt."""
        sch = self.scheduler
        for req in list(victims.values()):
            sch.fault_terminate(req, kind="dispatch")
        self._rec.emit("engine", "device_fault_step", bucket=bucket,
                       kind="dispatch", rows=len(victims),
                       error=str(err)[:200] if err else "")

    def _async_step_failed(self, stp: _InFlight, err) -> None:
        """A pipelined step's results failed to arrive at commit (a
        non-sticky error): every later step in flight consumed its
        carry, so the whole pipeline is dropped — the live rows of this
        step and of every later one are quarantined."""
        later = list(self._inflight)
        self._inflight.clear()
        victims: Dict[int, Request] = {}
        for s in [stp] + later:
            for r in s.plan.rows:
                if r.request.rid not in s.dead:
                    victims[r.request.rid] = r.request
        self._quarantine_failed_step(victims, stp.bucket, err)
        self._inflight_out[:] = 0
        self.steps_committed += len(later)   # they will never commit

    def _land_step(self, stp: _InFlight, toks: np.ndarray) -> None:
        """Land every live row: chunk cursor advances, prefill
        completions (first tokens), decode and verify tokens; then the
        step's counters, recorder events and cost-ledger accounting."""
        sch = self.scheduler
        prof = self.stepprof
        now = time.perf_counter()
        t0, bucket = stp.t0, stp.bucket
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
        out_tokens = 0
        for r in chunk_rows:
            req = r.request
            slot = req.slot
            self._rec.emit("request", "prefill_chunk", rid=req.rid, ts=t0,
                           dur=now - t0, start=r.start, tokens=r.chunk_len,
                           slot=slot)
            if not r.final_chunk:
                sch.on_chunk_done(req, r)
                continue
            first = int(toks[q_starts[slot] + q_lens[slot] - 1])
            self._obs["prefill_latency"].observe(now - req.t_prefill_start)
            self._obs["ttft"].observe(now - (req.t_submit or now))
            self._obs["tokens"].inc()
            out_tokens += 1
            # the whole chunk train renders as ONE prefill slice
            self._rec.emit("request", "prefill", rid=req.rid,
                           ts=req.t_prefill_start,
                           dur=now - req.t_prefill_start, bucket=bucket,
                           slot=slot, chunks=req.prefill_chunks,
                           cached_tokens=req.prefix_len)
            sch.on_chunk_done(req, r, first, self.eos_id)
            if req.state != "finished":
                self._tok_matrix[slot, self._row_len[slot]] = first
                self._row_len[slot] += 1
        n_verify = sum(1 for r in decode_rows if stp.drafts.get(
            r.request.slot))
        if decode_rows:
            out_tokens += self._land_verify_rows(
                decode_rows, stp.drafts, q_starts, stp.pre_lens, toks)
            self._obs["decode_latency"].observe(now - t0)
            self._rec.emit("engine", "decode_step", ts=t0, dur=now - t0,
                           n_active=len(decode_rows))
        n_chunk, n_plain = len(chunk_rows), len(decode_rows) - n_verify
        for kind, n in (("chunk", n_chunk), ("decode", n_plain),
                        ("verify", n_verify)):
            if n:
                self._obs["mixed_rows"].labels(kind=kind).inc(n)
        self._rec.emit("engine", "mixed_step", ts=t0, dur=now - t0,
                       chunk_rows=n_chunk, decode_rows=n_plain,
                       verify_rows=n_verify, tokens=stp.n_ragged,
                       bucket=bucket)
        if self.ledger is not None:
            # the landed rows at their real ragged lengths: chunk rows
            # span their context window, decode/verify rows attend the
            # pre-step residency plus their own tokens; dead rows landed
            # nothing and cost nothing here
            led_rows = (
                [(r.request, r.chunk_len, r.start + r.chunk_len)
                 for r in chunk_rows]
                + [(r.request, int(q_lens[r.request.slot]),
                    stp.pre_lens.get(r.request.slot, 0)
                    + int(q_lens[r.request.slot]))
                   for r in decode_rows])
            step_bytes, step_flops = self.ledger.account_step(led_rows)
            if stp.fence_s is not None:
                tenant_pages = {t: int(u.get("pages", 0))
                                for t, u in sch.tenant_usage().items()}
                self.ledger.observe_roofline(bucket, step_bytes, step_flops,
                                             stp.fence_s, tenant_pages)
        prof.annotate(tokens=stp.n_ragged, bucket=bucket,
                      chunk_rows=n_chunk, decode_rows=n_plain,
                      verify_rows=n_verify, tokens_out=out_tokens)
        prof.note_tokens(out_tokens)
        prof.lap("sample_commit")

    def _land_verify_rows(self, decode_rows: List[RowPlan],
                          drafts: Dict[int, List[int]], q_starts, pre_lens,
                          toks) -> int:
        """Land the decode and verify rows: per slot, accept the longest
        draft prefix that matches the target's samples and emit the
        accepted drafts plus one more token (the bonus on full
        acceptance, the corrected target on a mismatch; a draftless row
        emits its one token). The rejected tail's K/V is rolled back with
        ``cache.truncate`` under the request's reserve floor. An EOS
        inside a block stops delivery at the EOS. A step in which any
        slot drafted counts in the ``n_spec_*`` stats. Returns the
        tokens delivered."""
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
        n_emitted = sum(delivered.values())
        self._obs["tokens"].inc(n_emitted)
        if drafts:
            sch.stats["n_spec_steps"] += 1
            sch.stats["n_spec_slot_steps"] += n_active
            sch.stats["n_spec_drafted"] += n_drafted
            sch.stats["n_spec_accepted"] += n_accepted
            sch.stats["n_spec_emitted"] += n_emitted
            self._spec_drafted_total += n_drafted
            self._spec_accepted_total += n_accepted
            self._obs["spec_drafted"].inc(n_drafted)
            self._obs["spec_accepted"].inc(n_accepted)
            if self._spec_drafted_total:
                self._obs["spec_ratio"].set(self._spec_accepted_total
                                            / self._spec_drafted_total)
            self._rec.emit("engine", "spec_verify", n_active=n_active,
                           drafted=n_drafted, accepted=n_accepted,
                           emitted=n_emitted)
        # each still-running slot's landed tokens join its host context
        # (the next pending token and the drafter's input)
        for r in decode_rows:
            req = r.request
            if req.state == "running":
                out = emitted[req.slot]
                rl = self._row_len[req.slot]
                self._tok_matrix[req.slot, rl:rl + len(out)] = out
                self._row_len[req.slot] += len(out)
        return n_emitted

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
    def _dispatch(self, stp: _InFlight, max_q: int,
                  retry: bool = False) -> None:
        """Run one step and start its results on their way to the host:
        fills ``stp``'s ``toks``/``ok`` (host arrays; on the card views
        of a pinned ring entry, valid once ``stp.event`` completes) and
        its device-span fields. ``retry`` (the fault boundary's depth-0
        retry of a step already dispatched) runs it again on the same
        route, its graph replayed, outside the signature bookkeeping.

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
        memory. The step profiler's start event (when it is on) is
        recorded before the input copies, the end event after the
        output copies: around the replay, never inside a graph."""
        bucket, ints, floats = stp.bucket, stp.ints, stp.floats
        tiles = max_q > DECODE_MAX_Q
        key = ("step", bucket, tiles)
        if not retry:
            self._note_signature(key)
            self.steps_by_class["mix" if tiles else "decode"] += 1
        levels = self._device_page_levels()
        run = (self._eager_fn if self.obs_registry.enabled
               else self._run_step)
        stp.t0 = time.perf_counter()
        if self.device.type != "cuda":
            self._graphs.setdefault(key, None)
            toks, ok = run(bucket, torch.from_numpy(ints),
                           torch.from_numpy(floats), max_q, levels)
            stp.toks, stp.ok = toks.numpy(), ok.numpy()
            stp.t_done = time.perf_counter()
            return
        slot = self._ring_slot()
        if self.stepprof.active:
            slot.start.record()
            stp.start_ev, stp.prev_end = slot.start, self._prev_end
        slot.ints[:len(ints)].numpy()[:] = ints
        slot.floats[:len(floats)].numpy()[:] = floats
        ints_d, floats_d = self._bucket_inputs(bucket, len(ints),
                                               len(floats))
        ints_d.copy_(slot.ints[:len(ints)], non_blocking=True)
        floats_d.copy_(slot.floats[:len(floats)], non_blocking=True)
        graph = self._graphs.get(key)
        if graph is not None:
            if self.obs_registry.enabled:
                self._replay_fn(key)
            else:
                self._replay(key)
            toks, ok = graph.toks, graph.ok
        elif retry or not self.cuda_graphs:
            self._graphs.setdefault(key, None)
            toks, ok = run(bucket, ints_d, floats_d, max_q, levels)
        else:
            grid_q = bucket if tiles else max_q
            toks, ok = run(bucket, ints_d, floats_d, grid_q, levels)
            self._graphs[key] = self._capture(bucket, ints_d, floats_d,
                                              grid_q, levels, tiles)
        slot.toks[:bucket].copy_(toks, non_blocking=True)
        slot.ok[:bucket].copy_(ok, non_blocking=True)
        slot.event.record()
        self._prev_end = slot.event
        stp.toks, stp.ok = (slot.toks[:bucket].numpy(),
                            slot.ok[:bucket].numpy())
        stp.event = slot.event

    def _note_signature(self, key) -> None:
        """The compile observatory's view of one step's graph lookup: a
        miss is a signature this engine has not launched before
        (exactly what grows ``xla_compiles``)."""
        miss = key not in self._graphs
        if miss:
            self._obs["compiles"].labels(graph="step").inc()
        if self.ledger is not None:
            self.ledger.note_dispatch("step", miss, key[1])

    def _replay(self, key) -> None:
        graph = self._graphs[key]
        graph.graph.replay()
        pa.LAUNCHES.update(graph.held)

    def _run_step(self, bucket, ints, floats, max_q, levels):
        return _step(self.model, self.cache, levels, ints, floats,
                     self._carry_d, bucket, self._attn_tier,
                     max_q_len=max_q, quant=self.quant,
                     kv_split_pages=self._kv_split_pages)

    def _capture(self, bucket, ints_d, floats_d, max_q, levels,
                 tiles: bool) -> _StepGraph:
        """Capture the step of ``bucket`` over its static inputs into a
        CUDA graph (nothing runs); its wall time and memory go to the
        compile observatory. Raises :class:`GraphCaptureError` if the
        capture fails."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
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
        except Exception as e:         # noqa: BLE001 — no eager fallback
            raise GraphCaptureError(
                f"capture of the step of bucket {bucket} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        if self.ledger is not None:
            self.ledger.observe_capture(
                "step", bucket, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(),
                torch.cuda.memory_allocated() - before, tiles=tiles)
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
                    event=torch.cuda.Event(enable_timing=True),
                    start=torch.cuda.Event(enable_timing=True)))
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
