"""The port's serving engine against the JAX engine, end to end.

Both engines serve ``JaxLM.tiny``'s weights (carried across with
``params_from_jax``) under identical explicit cache and scheduler
configs. Greedy and sampled tokens must be equal — with a shared
prompt prefix (a prefix-cache hit), with chunked prefill, with EOS and
with a cancel — and the port's logits at every engine step must match
the JAX step recomputed on the same inputs (teacher forcing).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm import (  # noqa: E402
    CacheConfig as JaxCacheConfig, GenerationEngine as JaxEngine, JaxLM,
    SamplingParams as JaxSP, SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import model as jmodel  # noqa: E402
from paddle_tpu.inference.llm.quant import (  # noqa: E402
    QuantConfig as JaxQuantConfig)
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, SamplingParams, SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm.quant import QuantConfig  # noqa: E402
from paddle_tpu_torch.inference.llm import engine as tengine  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

GEOM = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=64,
            page_size=8, max_slots=4, max_seq_len=128, prefix_cache=True,
            swap_pages=0, demote_cold_prefix=False)
NEW = 10


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny()
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128, size=40).tolist()
    return [shared + rng.integers(0, 128, size=5).tolist(),
            rng.integers(0, 128, size=17).tolist(),
            shared + rng.integers(0, 128, size=9).tolist(),
            rng.integers(0, 128, size=3).tolist(),
            rng.integers(0, 128, size=30).tolist()]


def _engines(models, chunk_tokens=0, eos_id=None):
    jm, tm = models
    sched = dict(max_slots=4, max_seq_len=128, chunk_tokens=chunk_tokens)
    je = JaxEngine(jm, cache_config=JaxCacheConfig(**GEOM),
                   scheduler_config=JaxSchedulerConfig(**sched),
                   eos_id=eos_id)
    te = GenerationEngine(tm, cache_config=CacheConfig(**GEOM),
                          scheduler_config=SchedulerConfig(**sched),
                          eos_id=eos_id, device="cpu")
    return je, te


SAMPLING = {"greedy": None, "sampled": (0.8, 20, 0.9, 7),
            "seedless": (1.0, 0, 1.0, None)}


@pytest.mark.parametrize("chunk_tokens", [0, 8])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_generate_tokens_equal(models, chunk_tokens, sampling):
    je, te = _engines(models, chunk_tokens)
    sp = SAMPLING[sampling]
    want = je.generate(_prompts(), NEW, None if sp is None else JaxSP(*sp))
    got = te.generate(_prompts(), NEW,
                      None if sp is None else SamplingParams(*sp))
    assert got == want
    assert te.cache.prefix_hits == je.cache.prefix_hits > 0
    te.cache.check_invariants()
    assert te.cache.pages_in_use == 0


def test_logits_match_at_every_step(models, monkeypatch):
    """Teacher forcing: every ``lm_ragged_step`` the port's engine runs
    is recomputed by the JAX step on the same inputs (tokens, row
    metadata, pre-step pools, page table); logits agree at 1e-4 (float32
    matmul order differs between the backends)."""
    jm, _ = models
    calls = []
    real = tengine.lm_ragged_step

    def recording(params, spec, tokens, q_starts, q_lens, kv_lens, k_pool,
                  v_pool, page_table, **kw):
        pre = (k_pool.clone().numpy(), v_pool.clone().numpy())
        logits = real(params, spec, tokens, q_starts, q_lens, kv_lens,
                      k_pool, v_pool, page_table, **kw)
        calls.append([a.clone().numpy() for a in (tokens, q_starts, q_lens,
                                                  kv_lens, page_table)]
                     + list(pre) + [logits.numpy().copy()])
        return logits

    monkeypatch.setattr(tengine, "lm_ragged_step", recording)
    _, te = _engines(models, chunk_tokens=8)
    te.generate(_prompts(1), NEW, SamplingParams(0.9, 0, 1.0, 3))
    assert len(calls) == te.steps_dispatched > NEW
    for tokens, qs, ql, kv, pt, kp, vp, got in calls:
        _, _, _, _, want = jmodel.lm_ragged_step(
            jm.params, jm.spec, jnp.asarray(tokens), jnp.asarray(qs),
            jnp.asarray(ql), jnp.asarray(kv), jnp.asarray(kp),
            jnp.asarray(vp), jnp.asarray(pt), attn_tier="lax")
        n = int(ql.sum())
        rows = np.concatenate([np.arange(s, s + q) for s, q in zip(qs, ql)])
        assert len(rows) == n
        np.testing.assert_allclose(got[rows], np.asarray(want)[rows],
                                   rtol=1e-4, atol=1e-4)


def test_eos_and_cancel_equal(models):
    je, te = _engines(models)
    first = je.generate(_prompts(2)[:1], NEW)[0]
    eos = first[3]
    outs = []
    for eng in _engines(models, chunk_tokens=8, eos_id=eos):
        rids = [eng.submit(p, NEW) for p in _prompts(2)]
        for _ in range(4):
            eng.step()
        eng.cancel(rids[4])
        eng.run()
        reqs = eng.scheduler.finished
        outs.append([(list(reqs[r].output), reqs[r].finish_reason)
                     for r in rids])
    assert outs[1] == outs[0]
    reasons = {reason for _, reason in outs[1]}
    assert {"eos", "cancelled"} <= reasons


def test_default_device_engine_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tm = models
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(tm)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_quantized_split_engine_tokens_equal(models, kv, sampling):
    """Quantized KV pages, int8 weights and the KV split (2-page
    chunks) with chunked prefill and a shared prefix: tokens equal the
    JAX engine's, and both caches hold the same prefix keys on the same
    pages (the content-hash salt is the same)."""
    jm, tm = models
    sched = dict(max_slots=4, max_seq_len=128, chunk_tokens=8,
                 kv_split_pages=2)
    je = JaxEngine(jm, cache_config=JaxCacheConfig(**GEOM),
                   scheduler_config=JaxSchedulerConfig(**sched),
                   quant=JaxQuantConfig(kv=kv, weights="int8"))
    te = GenerationEngine(tm, cache_config=CacheConfig(**GEOM),
                          scheduler_config=SchedulerConfig(**sched),
                          quant=QuantConfig(kv=kv, weights="int8"),
                          device="cpu")
    sp = SAMPLING[sampling]
    want = je.generate(_prompts(3), NEW, None if sp is None else JaxSP(*sp))
    got = te.generate(_prompts(3), NEW,
                      None if sp is None else SamplingParams(*sp))
    assert got == want
    assert te.cache.prefix_hits == je.cache.prefix_hits > 0
    assert te.cache._prefix_map == je.cache._prefix_map
    assert te.cache.k_pool.element_size() == 1
    assert te.model.params["l0.wqkv@q"].dtype == torch.int8
    te.cache.check_invariants()
    assert te.cache.pages_in_use == 0


def test_split_on_and_off_bit_exact_on_cpu(models):
    """The KV split is a schedule of the kernels: on the CPU's plain
    path an engine with it on gives the same tokens and the same pool
    bytes as one with it off."""
    _, tm = models
    runs = []
    for split in (0, 3):
        eng = GenerationEngine(
            tm, cache_config=CacheConfig(**GEOM),
            scheduler_config=SchedulerConfig(max_slots=4, max_seq_len=128,
                                             chunk_tokens=8,
                                             kv_split_pages=split,
                                             kv_quant="int8"),
            device="cpu")
        assert eng.quant == QuantConfig(kv="int8")
        runs.append((eng.generate(_prompts(4), NEW,
                                  SamplingParams(0.7, 10, 0.95, 5)),
                     eng.cache.k_pool.clone(), eng.cache.k_scale.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])


def test_explicit_off_quant_forces_the_float_engine(models):
    _, tm = models
    eng = GenerationEngine(
        tm, cache_config=CacheConfig(**GEOM),
        scheduler_config=SchedulerConfig(max_slots=4, max_seq_len=128,
                                         kv_quant="int8"),
        quant=QuantConfig(), device="cpu")
    assert eng.quant is None
    assert eng.cache.k_pool.dtype == torch.float32
    assert eng.cache.k_scale is None
    assert eng.model is tm
