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

Speculative drafts, async pipelining, the request journal, fault
injection and the NaN quarantine, the tensor-parallel mesh and the
observability hooks are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from .kv_cache import CacheConfig, PagedKVCache, flatten_page_levels
from .model import TorchLM, lm_ragged_step, resolve_carry_tokens, step_carry
from .quant import QuantConfig
from .scheduler import (ContinuousBatchingScheduler, Plan, QueueFull,
                        RowPlan, SchedulerConfig)
from .threefry import categorical, fold_in, prng_key

__all__ = ["SamplingParams", "GREEDY", "resolve_sampling",
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


def _step(model: TorchLM, cache: PagedKVCache, page_levels, row_meta,
          tok_meta, samp_meta, carry_in, attn_tier: str, max_q_len: int,
          quant: Optional[QuantConfig], kv_split_pages: int):
    """One unified step (the JAX engine's ``_step_jit_for`` body).

    ``page_levels``: the two-level table ``(slot_dir, index_pool)`` on
    the device, flattened here to the ``[max_slots, pages_per_seq]``
    page table the step consumes.
    ``row_meta [3, max_slots]``: q_starts / q_lens / kv_lens;
    ``tok_meta [5, bucket]``: tokens / tok_src / seeds / sample_pos /
    top_k; ``samp_meta [2, bucket]``: temperature / top_p. Updates the
    cache's pools in place and returns ``(toks [bucket], ok [bucket],
    carry_out [max_slots])``. Without speculative drafts only each
    row's LAST flat position is ever read (a chunk-final or decode
    token), so only those positions are sampled; the others stay 0.
    ``ok`` flags the flat positions whose logits are all finite."""
    q_starts, q_lens, kv_lens = row_meta[0], row_meta[1], row_meta[2]
    tokens, tok_src, seeds = tok_meta[0], tok_meta[1], tok_meta[2]
    sample_pos, top_k = tok_meta[3], tok_meta[4]
    temp, top_p = samp_meta[0], samp_meta[1]
    toks_in = resolve_carry_tokens(tokens, tok_src, carry_in)
    page_table = flatten_page_levels(page_levels[0], page_levels[1],
                                     cache.config.pages_per_seq)
    logits = lm_ragged_step(model.params, model.spec, toks_in, q_starts,
                            q_lens, kv_lens, cache.k_pool, cache.v_pool,
                            page_table, attn_tier=attn_tier,
                            max_q_len=max_q_len, k_scale=cache.k_scale,
                            v_scale=cache.v_scale, quant=quant,
                            kv_split_pages=kv_split_pages)
    # idle rows clamp to position 0 and recompute that position's
    # sample from the same inputs: the duplicate writes are identical
    last = torch.clamp(q_starts + q_lens - 1, min=0).long()
    toks = torch.zeros_like(tokens)
    toks[last] = _sample_traced(logits[last], seeds[last], sample_pos[last],
                                temp[last], top_k[last], top_p[last])
    ok = torch.isfinite(logits).all(dim=-1)
    return toks, ok, step_carry(toks, q_starts, q_lens, carry_in)


class GenerationEngine:
    """Ties scheduler + paged cache + model into a serving loop.

    ``device`` (default ``cuda``; pass ``"cpu"`` for the plain PyTorch
    path) must be where ``model`` lives. ``attn_tier``: ``"auto"`` (the
    CUDA kernel on the card, the plain version on the CPU), ``"kernel"``
    or ``"ref"``. ``quant`` (a :class:`QuantConfig`; ``None`` reads
    ``SchedulerConfig.kv_quant``/``weight_quant``) turns on quantized
    KV pages and weight-only int8; an explicit all-off config forces
    the float engine."""

    def __init__(self, model: TorchLM,
                 cache_config: Optional[CacheConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 eos_id: Optional[int] = None, attn_tier: str = "auto",
                 quant: Optional[QuantConfig] = None, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device} but the "
                             f"engine runs on {self.device}; build the "
                             "model on the engine's device")
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
        self._carry_d = torch.zeros((ms,), dtype=torch.int32,
                                    device=self.device)
        # device copy of the two-level page table, re-uploaded only when
        # the host table changed (allocate / release)
        self._levels_dev = None
        self._levels_version = -1
        self.steps_dispatched = 0

    # ------------------------------------------------------------ surface --
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, ttft_deadline_s: float = 0.0,
               deadline_s: float = 0.0) -> int:
        # validate BEFORE the seed draw: a rejected submit burns nothing
        # of the per-request seed stream
        self.scheduler._validate_submit(prompt, max_new_tokens, priority,
                                        ttft_deadline_s, deadline_s)
        sp = resolve_sampling(sampling, self._rng)
        return self.scheduler.submit(prompt, max_new_tokens, sp,
                                     priority=priority,
                                     ttft_deadline_s=ttft_deadline_s,
                                     deadline_s=deadline_s)

    def cancel(self, rid: int) -> bool:
        return self.scheduler.cancel(rid)

    def step(self) -> str:
        plan = self.scheduler.step_plan()
        if plan.kind == "mixed":
            self._run_mixed(plan)
        return plan.kind

    def run(self) -> None:
        while self.scheduler.has_work:
            if self.step() == "idle":
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
    def _run_mixed(self, plan: Plan) -> None:
        self._commit_step(self._prepare_step(plan))

    def _prepare_step(self, plan: Plan) -> dict:
        """Stage chunk contexts, pack the plan's rows into a flat ragged
        token block, and run the step for the block's bucket."""
        sch = self.scheduler
        chunk_rows = [r for r in plan.rows if r.kind == "chunk"]
        decode_rows = [r for r in plan.rows if r.kind == "decode"]
        for r in chunk_rows:
            if r.first_chunk:
                req = r.request
                ctx = req.kv_tokens()
                self._tok_matrix[req.slot, :] = 0
                self._tok_matrix[req.slot, :len(ctx)] = ctx
                self._row_len[req.slot] = len(ctx)
        ms = sch.config.max_slots
        q_starts = np.zeros((ms,), np.int32)
        q_lens = np.zeros((ms,), np.int32)
        kv_lens = np.zeros((ms,), np.int32)
        flat_tokens: List[int] = []
        seeds: List[int] = []
        sample_pos: List[int] = []
        temps: List[float] = []
        top_ks: List[int] = []
        top_ps: List[float] = []
        pre_lens: Dict[int, int] = {}    # decode rows: pre-step resident
        for r in plan.rows:
            req = r.request
            slot = req.slot
            sp = req.sampling or GREEDY
            if r.kind == "chunk":
                toks = req.kv_tokens()[r.start:r.start + r.chunk_len]
                ql = r.chunk_len
                kv = r.start + r.chunk_len
                # only the final position's sample is kept: output index
                # len(output) (0 for a fresh request)
                base = len(req.output) - (ql - 1)
            else:
                toks = [int(self._tok_matrix[slot, self._row_len[slot] - 1])]
                ql = 1
                n0 = int(self.cache.seq_lens[slot])
                pre_lens[slot] = n0
                kv = n0 + ql
                base = len(req.output)
            q_starts[slot] = len(flat_tokens)
            q_lens[slot] = ql
            kv_lens[slot] = kv
            flat_tokens.extend(int(t) for t in toks)
            for t in range(ql):
                seeds.append(sp.seed or 0)
                sample_pos.append(base + t)
                temps.append(sp.temperature)
                top_ks.append(sp.top_k)
                top_ps.append(sp.top_p)
        n = len(flat_tokens)
        bucket = sch.ragged_bucket_for(n)
        row_meta = np.stack([q_starts, q_lens, kv_lens]).astype(np.int32)
        tok_meta = np.zeros((5, bucket), np.int32)
        tok_meta[1, :] = -1                  # tok_src: host-fed tokens
        tok_meta[0, :n] = flat_tokens
        tok_meta[2, :n] = seeds
        tok_meta[3, :n] = sample_pos
        tok_meta[4, :n] = top_ks
        samp_meta = np.zeros((2, bucket), np.float32)
        samp_meta[0, :n] = temps
        samp_meta[1, :n] = top_ps
        toks_d, ok_d, self._carry_d = _step(
            self.model, self.cache, self._device_page_levels(),
            self._stage(row_meta), self._stage(tok_meta),
            self._stage(samp_meta), self._carry_d, self._attn_tier,
            max_q_len=int(q_lens.max()), quant=self.quant,
            kv_split_pages=self._kv_split_pages)
        self.steps_dispatched += 1
        return dict(chunk_rows=chunk_rows, decode_rows=decode_rows,
                    q_starts=q_starts, q_lens=q_lens, pre_lens=pre_lens,
                    toks=toks_d.cpu().numpy(), ok=ok_d.cpu().numpy())

    def _commit_step(self, stp: dict) -> None:
        """Check the landed rows' logits, then land them. The JAX engine
        quarantines a row with non-finite logits; until the port's
        device-fault slice brings that, such a row stops the engine."""
        ok, q_starts, q_lens = stp["ok"], stp["q_starts"], stp["q_lens"]
        bad = [r.request.rid for r in stp["chunk_rows"] + stp["decode_rows"]
               if not ok[q_starts[r.request.slot]:q_starts[r.request.slot]
                         + q_lens[r.request.slot]].all()]
        if bad:
            raise FloatingPointError(
                f"non-finite logits in the rows of requests {bad}")
        self._land_step(stp)

    def _land_step(self, stp: dict) -> None:
        """Land every row: chunk cursor advances, prefill completions
        (first tokens) and decode tokens."""
        sch = self.scheduler
        toks, q_starts, q_lens = stp["toks"], stp["q_starts"], stp["q_lens"]
        for r in stp["chunk_rows"]:
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
        decode_rows: List[RowPlan] = stp["decode_rows"]
        if not decode_rows:
            return
        emitted = {}
        for r in decode_rows:
            slot = r.request.slot
            self.cache.seq_lens[slot] = max(int(self.cache.seq_lens[slot]),
                                            stp["pre_lens"][slot] + 1)
            emitted[slot] = int(toks[q_starts[slot]])
        sch.on_decode_done(emitted, self.eos_id)
        for r in decode_rows:
            req = r.request
            if req.state == "running":
                slot = req.slot
                self._tok_matrix[slot, self._row_len[slot]] = emitted[slot]
                self._row_len[slot] += 1

    # --------------------------------------------------- device mirrors --
    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _device_page_levels(self):
        if self._levels_version != self.cache.page_table_version:
            self._levels_dev = self.cache.device_page_levels()
            self._levels_version = self.cache.page_table_version
        return self._levels_dev
