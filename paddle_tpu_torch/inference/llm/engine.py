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

Async pipelining, the request journal, fault injection and the NaN
quarantine, the tensor-parallel mesh and the observability hooks are
later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
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


def _step(model: TorchLM, cache: PagedKVCache, page_levels, row_meta,
          tok_meta, samp_meta, sample_idx, carry_in, attn_tier: str,
          max_q_len: int, quant: Optional[QuantConfig],
          kv_split_pages: int):
    """One unified step (the JAX engine's ``_step_jit_for`` body).

    ``page_levels``: the two-level table ``(slot_dir, index_pool)`` on
    the device, flattened here to the ``[max_slots, pages_per_seq]``
    page table the step consumes.
    ``row_meta [3, max_slots]``: q_starts / q_lens / kv_lens;
    ``tok_meta [5, bucket]``: tokens / tok_src / seeds / sample_pos /
    top_k; ``samp_meta [2, bucket]``: temperature / top_p;
    ``sample_idx``: the flat positions whose tokens landing reads —
    each chunk row's last one and every position of a decode or verify
    row — each sampled with its own (seed, token index) key; the other
    positions stay 0. Updates the cache's pools in place and returns
    ``(toks [bucket], ok [bucket], carry_out [max_slots])``. ``ok``
    flags the flat positions whose logits are all finite."""
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
    idx = sample_idx.long()
    toks = torch.zeros_like(tokens)
    toks[idx] = _sample_traced(logits[idx], seeds[idx], sample_pos[idx],
                               temp[idx], top_k[idx], top_p[idx])
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
        sample_idx: List[int] = []
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
                sample_idx.append(len(flat_tokens) + ql - 1)
            else:
                d = drafts.get(slot, [])
                toks = [int(self._tok_matrix[slot, self._row_len[slot] - 1])
                        ] + d
                ql = 1 + len(d)
                n0 = int(self.cache.seq_lens[slot])
                pre_lens[slot] = n0
                kv = n0 + ql
                # position t samples output index len(output) + t: the
                # keys of ql successive plain decode steps
                base = len(req.output)
                sample_idx.extend(range(len(flat_tokens),
                                        len(flat_tokens) + ql))
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
            self._stage(samp_meta),
            self._stage(np.asarray(sample_idx, np.int32)), self._carry_d,
            self._attn_tier,
            max_q_len=int(q_lens.max()), quant=self.quant,
            kv_split_pages=self._kv_split_pages)
        self.steps_dispatched += 1
        return dict(chunk_rows=chunk_rows, decode_rows=decode_rows,
                    drafts=drafts, q_starts=q_starts, q_lens=q_lens,
                    pre_lens=pre_lens, toks=toks_d.cpu().numpy(),
                    ok=ok_d.cpu().numpy())

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
        (first tokens), decode and verify tokens."""
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
        self._land_verify_rows(stp)

    def _land_verify_rows(self, stp: dict) -> None:
        """Land the decode and verify rows: per slot, accept the longest
        draft prefix that matches the target's samples and emit the
        accepted drafts plus one more token (the bonus on full
        acceptance, the corrected target on a mismatch; a draftless row
        emits its one token). The rejected tail's K/V is rolled back
        with ``cache.truncate`` under the request's reserve floor. An
        EOS inside a block stops delivery at the EOS. A step in which
        any slot drafted counts in the ``n_spec_*`` stats."""
        sch = self.scheduler
        toks, q_starts = stp["toks"], stp["q_starts"]
        drafts, pre_lens = stp["drafts"], stp["pre_lens"]
        emitted: Dict[int, List[int]] = {}
        n_active = n_drafted = n_accepted = 0
        for r in stp["decode_rows"]:
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
            # hold rejected drafts
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
        for r in stp["decode_rows"]:
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
        1`` tokens, so the verify row (drafts plus the bonus or corrected
        token) never overruns ``max_new_tokens`` or the reserved pages,
        and at the step budget's remainder when one is given."""
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
            remaining = req.max_new_tokens - len(req.output)
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

    # --------------------------------------------------- device mirrors --
    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _device_page_levels(self):
        if self._levels_version != self.cache.page_table_version:
            self._levels_dev = self.cache.device_page_levels()
            self._levels_version = self.cache.page_table_version
        return self._levels_dev
