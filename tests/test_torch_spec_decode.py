"""The port's speculative decoding against the JAX package.

- The drafting knobs and ``ngram_draft`` equal the JAX engine's, the
  latter on seeded contexts.
- The port's engine with ``spec_tokens=4`` gives the JAX engine's tokens
  and ``n_spec_*`` counters (greedy and sampled, with and without
  chunked prefill, float and int8 KV pages, with a step token budget).
- Inside the port on the CPU, speculation on and off give the same
  tokens, an EOS inside an accepted block included; an oracle drafter is
  always fully accepted; the adaptive ``spec_len`` follows the JAX
  engine's step for step on a rejecting workload.
- ``PagedKVCache.truncate`` and its scale-row zeroing mirror the JAX
  cache case by case (``tests/test_paged_kv_cache.py``), on both caches
  side by side; a full speculative run leaks no page.
- The ragged-token buckets equal the JAX ones for spec configs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference.llm import CacheConfig as JaxCacheConfig  # noqa: E402
from paddle_tpu.inference.llm import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.inference.llm import JaxLM, PagedKVCache as JaxCache  # noqa: E402
from paddle_tpu.inference.llm import SamplingParams as JaxSP  # noqa: E402
from paddle_tpu.inference.llm import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import engine as jengine  # noqa: E402
from paddle_tpu.inference.llm.quant import (  # noqa: E402
    QuantConfig as JaxQuantConfig)
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, PagedKVCache, SamplingParams,
    SchedulerConfig, TorchLM, ngram_draft, policy)
from paddle_tpu_torch.inference.llm import engine as tengine  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from paddle_tpu_torch.inference.llm.quant import QuantConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

GEOM = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=64,
            page_size=8, max_slots=4, max_seq_len=128, prefix_cache=True)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny()
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _prompts(seed=0):
    """Repetitive traffic, so n-gram drafts are proposed and accepted:
    two prompts repeat a motif, one shares a prefix with another, two
    are random."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, 128, size=6).tolist()
    shared = rng.integers(0, 128, size=24).tolist()
    return [np.tile(motif, 5).tolist()[:28], shared + motif * 2,
            shared + rng.integers(0, 128, size=7).tolist(),
            rng.integers(0, 128, size=17).tolist(),
            rng.integers(0, 128, size=33).tolist()]


def _engines(models, chunk_tokens=0, spec_tokens=4, eos_id=None, kv="off",
             budget=0):
    jm, tm = models
    sched = dict(max_slots=4, max_seq_len=128, chunk_tokens=chunk_tokens,
                 spec_tokens=spec_tokens, step_token_budget=budget)
    je = JaxEngine(jm, cache_config=JaxCacheConfig(**GEOM),
                   scheduler_config=JaxSchedulerConfig(**sched),
                   eos_id=eos_id, quant=JaxQuantConfig(kv=kv))
    te = GenerationEngine(tm, cache_config=CacheConfig(**GEOM),
                          scheduler_config=SchedulerConfig(**sched),
                          eos_id=eos_id, quant=QuantConfig(kv=kv),
                          device="cpu")
    return je, te


def _port_engine(models, spec_tokens=4, eos_id=None, **kw):
    sched = dict(max_slots=4, max_seq_len=128, spec_tokens=spec_tokens)
    sched.update(kw)
    return GenerationEngine(models[1], cache_config=CacheConfig(**GEOM),
                            scheduler_config=SchedulerConfig(**sched),
                            eos_id=eos_id, device="cpu")


SPEC_STATS = ("n_spec_steps", "n_spec_slot_steps", "n_spec_drafted",
              "n_spec_accepted", "n_spec_emitted")


def test_drafting_knobs_match_the_reference():
    for name in ("SPEC_NGRAM_MAX", "SPEC_NGRAM_MIN", "SPEC_WINDOW",
                 "SPEC_PROBE_EVERY", "SPEC_DECAY_BELOW", "SPEC_GROW_ABOVE"):
        assert getattr(policy, name) == getattr(jengine, name), name


@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_equal(seed):
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, 9, size=int(rng.integers(2, 7)))
    contexts = [rng.integers(0, 6, size=n).astype(np.int32)
                for n in (0, 2, 3, 5, 12, 40)]
    contexts += [np.tile(motif, 6).astype(np.int32),
                 np.concatenate([rng.integers(0, 50, size=20),
                                 np.tile(motif, 3)]).astype(np.int32)]
    for ctx in contexts:
        for max_tokens in (0, 1, 3, 4, 7):
            assert (ngram_draft(ctx, max_tokens)
                    == jengine.ngram_draft(ctx, max_tokens)), (ctx,
                                                               max_tokens)


SAMPLING = {"greedy": None, "near_greedy": (0.2, 4, 0.9, 2),
            "sampled": (0.9, 20, 0.9, 7)}


@pytest.mark.parametrize("chunk_tokens,kv,budget", [
    (0, "off", 0), (8, "off", 0), (8, "int8", 0), (8, "off", 14)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_spec_engine_matches_jax(models, chunk_tokens, kv, budget, sampling):
    """With a step budget (14 tokens: the chunk and the pending tokens
    leave drafts a few or none) the drafts are shed as in JAX."""
    je, te = _engines(models, chunk_tokens, kv=kv, budget=budget)
    sp = SAMPLING[sampling]
    want = je.generate(_prompts(), 20, None if sp is None else JaxSP(*sp))
    got = te.generate(_prompts(), 20,
                      None if sp is None else SamplingParams(*sp))
    assert got == want
    assert ({k: te.scheduler.stats[k] for k in SPEC_STATS}
            == {k: je.scheduler.stats[k] for k in SPEC_STATS})
    if sampling != "sampled":
        assert te.scheduler.stats["n_spec_accepted"] > 0
    for rid, req in te.scheduler.finished.items():
        jreq = je.scheduler.finished[je.scheduler.rid_base + rid]
        assert ((req.spec_len, req.spec_drafted, req.spec_accepted)
                == (jreq.spec_len, jreq.spec_drafted, jreq.spec_accepted))
    assert te.cache.prefix_hits == je.cache.prefix_hits > 0
    te.cache.check_invariants()
    assert te.cache.pages_in_use == 0
    assert te.cache.scale_pool_clean()


def test_spec_on_and_off_bit_exact(models):
    for sp in (None, SamplingParams(*SAMPLING["near_greedy"])):
        on = _port_engine(models)
        got = on.generate(_prompts(1), 24, sp)
        assert got == _port_engine(models, spec_tokens=0).generate(
            _prompts(1), 24, sp)
        assert on.scheduler.stats["n_spec_accepted"] > 0


def test_eos_inside_an_accepted_block_stops_exactly(models, monkeypatch):
    """An oracle drafter proposes the true continuation, so every verify
    block is accepted whole; the EOS is a token first emitted inside such
    a block. Delivery stops at the EOS (the rest of the block dropped and
    counted nowhere), exactly as with speculation off, and no page
    leaks."""
    prompt = _prompts(2)[3]
    sp = SamplingParams(temperature=0.9, top_k=16, top_p=0.9, seed=42)
    base = _port_engine(models, spec_tokens=0).generate([prompt], 24, sp)[0]
    expected = list(prompt) + base
    monkeypatch.setattr(
        tengine, "ngram_draft",
        lambda context, max_tokens, **kw:
        expected[len(context):len(context) + max_tokens])
    landed = []
    eng = _port_engine(models)
    real = eng.scheduler.on_verify_done

    def recording(emitted, eos_id):
        for slot, block in emitted.items():
            landed.append((len(eng.scheduler.running[slot].output), block))
        return real(emitted, eos_id)

    eng.scheduler.on_verify_done = recording
    assert eng.generate([prompt], 24, sp)[0] == base
    eos = next(block[i] for start, block in landed
               for i in range(len(block) - 1)
               if base.index(block[i]) == start + i)
    cut = base[:base.index(eos) + 1]
    for spec_tokens in (4, 0):
        eng = _port_engine(models, spec_tokens=spec_tokens, eos_id=eos)
        rid = eng.submit(prompt, 24, sp)
        eng.run()
        req = eng.scheduler.finished[rid]
        assert (req.output, req.finish_reason) == (cut, "eos")
        assert eng.cache.pages_in_use == 0
        eng.cache.check_invariants()
        if spec_tokens:
            st = eng.scheduler.stats
            assert st["n_spec_accepted"] == st["n_spec_drafted"] > 0
            assert len(cut) == 1 + st["n_spec_emitted"]


def test_oracle_drafts_are_always_accepted(models, monkeypatch):
    prompt = _prompts(2)[3]
    sp = SamplingParams(temperature=0.9, top_k=16, top_p=0.9, seed=42)
    base = _port_engine(models, spec_tokens=0).generate([prompt], 24, sp)[0]
    expected = list(prompt) + base

    def oracle(context, max_tokens, **kw):
        assert list(context) == expected[:len(context)]
        return expected[len(context):len(context) + max_tokens]

    monkeypatch.setattr(tengine, "ngram_draft", oracle)
    eng = _port_engine(models)
    assert eng.generate([prompt], 24, sp)[0] == base
    st = eng.scheduler.stats
    assert st["n_spec_drafted"] > 0
    assert st["n_spec_accepted"] == st["n_spec_drafted"]
    assert st["n_spec_emitted"] == (st["n_spec_drafted"]
                                    + st["n_spec_slot_steps"])


def test_adaptive_spec_len_decays_like_jax(models, monkeypatch):
    """An always-wrong drafter on a repetitive prompt: the port's
    ``spec_len`` takes the JAX engine's value after every step, decays
    to 0, re-probes after ``SPEC_PROBE_EVERY`` quiet steps, and the
    tokens equal plain decoding."""
    wrong = lambda context, max_tokens, **kw: [127] * max_tokens  # noqa
    monkeypatch.setattr(jengine, "ngram_draft", wrong)
    monkeypatch.setattr(tengine, "ngram_draft", wrong)
    je, te = _engines(models)
    trajectories = []
    for eng in (je, te):
        rid = eng.submit([3, 4] * 8, 60)
        req = eng.scheduler.requests[rid]
        seen = []
        while eng.scheduler.has_work:
            eng.step()
            seen.append((req.spec_len, req.spec_idle, len(req.spec_window)))
        trajectories.append((seen, list(req.output)))
    assert trajectories[1] == trajectories[0]
    lens = [s[0] for s in trajectories[1][0]]
    assert 0 in lens and lens.index(0) < len(lens) - 1
    assert 1 in lens[lens.index(0):]                 # the re-probe
    plain = _port_engine(models, spec_tokens=0).generate([[3, 4] * 8], 60)
    assert trajectories[1][1] == plain[0]


def test_full_spec_run_leaves_zero_leaked_pages(models, monkeypatch):
    """Concurrent requests with rollbacks forced (every other draft
    wrong) and int8 pages: invariants hold after every step, and at the
    end the pool and the scale rows are back to their free state."""
    calls = [0]

    def flaky(context, max_tokens, **kw):
        calls[0] += 1
        draft = ngram_draft(context, max_tokens)
        return draft if calls[0] % 2 else [1] * max_tokens

    monkeypatch.setattr(tengine, "ngram_draft", flaky)
    eng = GenerationEngine(
        models[1], cache_config=CacheConfig(**dict(GEOM, max_slots=3)),
        scheduler_config=SchedulerConfig(max_slots=3, max_seq_len=128,
                                         chunk_tokens=8, spec_tokens=4),
        quant=QuantConfig(kv="int8"), device="cpu")
    rng = np.random.default_rng(18)
    for p, n in zip(_prompts(3) + _prompts(4),
                    rng.integers(4, 30, size=10).tolist()):
        eng.submit(p, n)
    while eng.scheduler.has_work:
        eng.step()
        eng.cache.check_invariants()
    st = eng.scheduler.stats
    assert st["n_spec_drafted"] > st["n_spec_accepted"] > 0
    c = eng.cache
    assert c.pages_in_use == 0
    assert sorted(list(c._free) + list(c._evictable)) == list(
        range(1, c.config.num_pages))
    assert c.scale_pool_clean()


@pytest.mark.parametrize("kw", [dict(spec_tokens=4),
                                dict(spec_tokens=2, chunk_tokens=24),
                                dict(spec_tokens=3, step_token_budget=40),
                                dict(spec_tokens=4, max_seq_len=1024,
                                     max_slots=8, chunk_tokens=512)])
def test_step_buckets_equal_for_spec_configs(kw):
    t, j = SchedulerConfig(**kw), JaxSchedulerConfig(**kw)
    assert t.max_step_tokens() == j.max_step_tokens()
    assert t.step_buckets() == j.step_buckets()


# --------------------------------------------------------------- truncate


def _cfg(**kw):
    base = dict(num_layers=2, num_heads=2, head_dim=8, num_pages=16,
                page_size=4, max_slots=4, max_seq_len=32,
                prefix_cache=False)
    base.update(kw)
    return base


def _state(c):
    return (list(c._free), list(c._evictable),
            {s: list(p) for s, p in c._allocated_pages.items()},
            [int(x) for x in c.seq_lens], c._refcount.tolist(),
            np.asarray(c.page_table).tolist(), np.asarray(c.slot_dir).tolist(),
            sorted(c._dir_free), c.num_free_pages, c.pages_in_use)


class Both:
    """A JAX cache and a port cache under one config, driven alike: each
    call runs on both and must return the same value or raise the same
    error type, and leave the same state."""

    def __init__(self, **kw):
        self.j = JaxCache(JaxCacheConfig(**_cfg(**kw)))
        self.t = PagedKVCache(CacheConfig(**_cfg(**kw)), device="cpu")

    def __call__(self, name, *args, **kw):
        out = []
        for c in (self.j, self.t):
            try:
                out.append(("ok", getattr(c, name)(*args, **kw)))
            except (RuntimeError, ValueError) as e:
                out.append((type(e).__name__, str(e).split(":")[0]))
        assert out[1] == out[0], (name, args, out)
        assert _state(self.t) == _state(self.j), (name, args)
        self.t.check_invariants()
        return out[1][1] if out[1][0] == "ok" else out[1]

    def set_len(self, slot, n):
        self.j.seq_lens[slot] = n
        self.t.seq_lens[slot] = n


def test_truncate_within_page_is_pure_accounting():
    c = Both()
    assert c("allocate", 0, 8)
    c.set_len(0, 7)
    before = list(c.t._free)
    assert c("truncate", 0, 2) == 0
    assert int(c.t.seq_lens[0]) == 5 and c.t._free == before


def test_truncate_across_page_boundaries_restores_the_free_list():
    c = Both()
    before = sorted(c.t._free)
    assert c("allocate", 0, 12)
    c.set_len(0, 10)
    tail = c.t._allocated_pages[0][-1]
    assert c("truncate", 0, 4) == 1
    assert c.t._free[-1] == tail and c.t.page_table[0, 2] == 0
    c.set_len(0, 8)
    assert c("truncate", 0, 7) == 1
    c("release", 0)
    assert sorted(c.t._free) == before


def test_truncate_frees_whole_index_rows():
    """A slot spanning three index rows (fanout 8) truncated to one
    page: two rows return to the row free list, the kept row's slack
    resets to garbage."""
    c = Both(num_pages=40, max_seq_len=128)
    assert c.t._dir_fanout == 8
    assert c("allocate", 0, 80)                 # 20 pages, 3 index rows
    assert len(c.t._slot_rows[0]) == 3
    c.set_len(0, 80)
    assert c("truncate", 0, 77) == 19
    assert len(c.t._slot_rows[0]) == 1


def test_truncate_respects_the_reserve_floor():
    c = Both()
    assert c("allocate", 0, 12)
    c.set_len(0, 10)
    assert c("truncate", 0, 9, reserve_tokens=12) == 0
    assert len(c.t._allocated_pages[0]) == 3
    c("release", 0)
    assert c.t.num_free_pages == c.t.config.num_pages - 1


def test_truncate_refusals_mutate_nothing():
    c = Both(prefix_cache=True)
    assert c("truncate", 0, 1)[0] == "RuntimeError"      # no allocation
    prompt = list(range(12))
    assert c("allocate", 0, 12, prompt=prompt)
    c.set_len(0, 3)
    assert c("truncate", 0, 4)[0] == "RuntimeError"      # underflow
    assert c("truncate", 0, -1)[0] == "ValueError"
    c.set_len(0, 12)
    c("commit_prefix", 0, prompt)
    assert c("truncate", 0, 12)[0] == "RuntimeError"     # cached pages
    assert c("allocate", 1, 16, prompt=prompt)
    assert c.t.prefix_len(1) == 8
    c.set_len(1, 10)
    assert c("truncate", 1, 3)[0] == "RuntimeError"      # prefix boundary
    c.set_len(1, 9)
    c.j._prefix_lens[1] = c.t._prefix_lens[1] = 0        # past the guard
    assert c("truncate", 1, 9)[0] == "RuntimeError"      # shared page
    assert int(c.t.seq_lens[1]) == 9


def _dirty(c, slot):
    """Nonzero scales on the slot's pages, on both caches."""
    import jax.numpy as jnp

    pages = c.t._allocated_pages[slot]
    c.j.k_scale = c.j.k_scale.at[:, jnp.asarray(pages)].set(0.25)
    c.j.v_scale = c.j.v_scale.at[:, jnp.asarray(pages)].set(0.5)
    c.t.k_scale[:, pages] = 0.25
    c.t.v_scale[:, pages] = 0.5


def test_quantized_truncate_zeroes_the_freed_scale_rows():
    c = Both(kv_quant="int8")
    assert c("allocate", 0, 12)
    _dirty(c, 0)
    c.set_len(0, 10)
    assert c("truncate", 0, 9, reserve_tokens=12) == 0   # under the floor
    assert (c.t.k_scale[:, c.t._allocated_pages[0]] == 0.25).all()
    c.set_len(0, 10)
    tail = c.t._allocated_pages[0][-1]
    kept = c.t._allocated_pages[0][0]
    assert c("truncate", 0, 4) == 1
    for side in (c.t, c.j):
        ks, vs = np.asarray(side.k_scale), np.asarray(side.v_scale)
        assert (ks[:, tail] == 0).all() and (vs[:, tail] == 0).all()
        assert (ks[:, kept] == 0.25).all()
        assert side.scale_pool_clean()
    c("release", 0)
    assert c.t.scale_pool_clean() and c.j.scale_pool_clean()
    np.testing.assert_array_equal(c.t.k_scale.numpy(),
                                  np.asarray(c.j.k_scale))
