"""The port's per-tier serving graphs against the JAX package.

``JaxLM.tiny``'s parameters are carried across with ``params_from_jax``;
the same seeded numpy inputs go through both sides.

- The scatter helpers (``page_offsets``, ``chunk_page_indices``,
  ``block_page_indices``, ``append_kv``, ``write_prefill_kv``,
  ``write_chunk_kv``) are integer bookkeeping and copies: bit-equal to
  the JAX ones (page 0, the garbage page, takes duplicate padding writes
  and is left out of pool comparisons).
- ``lm_prefill``, ``lm_chunk_prefill``, ``lm_decode`` and ``lm_verify``
  (float and weight-only int8) against their JAX counterparts on the
  lax tier, with pools threaded through several calls: logits and the
  pools' real pages agree at rtol = atol = 1e-4 (the two backends order
  their float32 matmul sums differently).
- A per-request loop over the port's per-tier graphs (chunked prefill,
  then ``lm_verify`` when ``ngram_draft`` proposes drafts and
  ``lm_decode`` otherwise) gives the tokens of the port's unified engine
  with chunked prefill, the prefix cache and ``spec_tokens=4`` on, for
  greedy and sampled requests: ``TestEndToEndBitExactness`` of the JAX
  package, without its preemption (not ported).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm import kv_cache as jkv  # noqa: E402
from paddle_tpu.inference.llm import model as jmodel  # noqa: E402
from paddle_tpu.inference.llm.model import JaxLM  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, GenerationEngine, PagedKVCache, SamplingParams,
    SchedulerConfig, TorchLM, ngram_draft)
from paddle_tpu_torch.inference.llm import kv_cache as tkv  # noqa: E402
from paddle_tpu_torch.inference.llm import model as tmodel  # noqa: E402
from paddle_tpu_torch.inference.llm.engine import (  # noqa: E402
    GREEDY, _sample_traced)
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4
PAGE = 8


def _pair(jm):
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


@pytest.fixture(scope="module")
def models():
    return _pair(JaxLM.tiny())


@pytest.fixture(scope="module")
def models_int8():
    return _pair(JaxLM.tiny().quantize_weights())


def _page_table(slots, pps, seed=0):
    pages = np.arange(1, 1 + slots * pps, dtype=np.int32)
    return np.random.default_rng(seed).permutation(pages).reshape(slots, pps)


def _pools(spec, n_pages, rng):
    shape = (spec.num_layers, n_pages, PAGE, spec.num_heads, spec.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(k), jnp.asarray(v),
            torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))


def _close_pools(kt, vt, kj, vj):
    np.testing.assert_allclose(kt[:, 1:].numpy(), np.asarray(kj)[:, 1:],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vt[:, 1:].numpy(), np.asarray(vj)[:, 1:],
                               rtol=TOL, atol=TOL)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ kv helpers


@pytest.mark.parametrize("start,chunk_len,width", [(0, 10, 16), (5, 16, 16),
                                                   (40, 3, 16), (47, 1, 4)])
def test_chunk_page_indices_equal(start, chunk_len, width):
    row = _page_table(1, 6)[0]
    want = jkv.chunk_page_indices(jnp.asarray(row), start, chunk_len, width,
                                  PAGE)
    got = tkv.chunk_page_indices(_t(row), start, chunk_len, width, PAGE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_block_page_indices_and_page_offsets_equal():
    pt = _page_table(4, 6)
    starts = np.asarray([0, 13, 44, 46], np.int32)
    q_lens = np.asarray([5, 1, 0, 3], np.int32)
    want = jkv.block_page_indices(jnp.asarray(pt), jnp.asarray(starts),
                                  jnp.asarray(q_lens), 5, PAGE)
    got = tkv.block_page_indices(_t(pt), _t(starts), _t(q_lens), 5, PAGE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    positions = np.asarray([0, 7, 8, 47], np.int32)
    want = jkv.page_offsets(jnp.asarray(pt), jnp.asarray(positions), PAGE)
    got = tkv.page_offsets(_t(pt), _t(positions), PAGE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scatter_helpers_equal(models):
    spec = models[0].spec
    rng = np.random.default_rng(3)
    L, H, D = spec.num_layers, spec.num_heads, spec.head_dim
    pt = _page_table(3, 6)
    kj, vj, kt, vt = _pools(spec, pt.size + 1, rng)

    def new(*lead):
        return rng.normal(size=(L,) + lead + (H, D)).astype(np.float32)

    k1, v1 = new(3), new(3)
    pos = np.asarray([4, 17, 30], np.int32)
    kj, vj = jkv.append_kv(kj, vj, k1, v1, jnp.asarray(pt),
                           jnp.asarray(pos))
    assert tkv.append_kv(kt, vt, _t(k1), _t(v1), _t(pt), _t(pos))[0] is kt
    k2, v2 = new(16), new(16)
    kj, vj = jkv.write_prefill_kv(kj, vj, k2, v2, jnp.asarray(pt[1]), 11)
    tkv.write_prefill_kv(kt, vt, _t(k2), _t(v2), _t(pt[1]), 11)
    k3, v3 = new(8), new(8)
    kj, vj = jkv.write_chunk_kv(kj, vj, k3, v3, jnp.asarray(pt[2]), 20, 5)
    tkv.write_chunk_kv(kt, vt, _t(k3), _t(v3), _t(pt[2]), 20, 5)
    np.testing.assert_array_equal(kt[:, 1:].numpy(), np.asarray(kj)[:, 1:])
    np.testing.assert_array_equal(vt[:, 1:].numpy(), np.asarray(vj)[:, 1:])


# -------------------------------------------------------- per-tier graphs


def test_lm_prefill_matches_jax(models):
    jm, tm = models
    tokens = np.random.default_rng(1).integers(
        0, jm.spec.vocab, size=(2, 12)).astype(np.int32)
    lj, kj, vj = jmodel.lm_prefill(jm.params, jm.spec, jnp.asarray(tokens))
    lt, kt, vt = tmodel.lm_prefill(tm.params, tm.spec, _t(tokens))
    for got, want in ((lt, lj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_lm_chunk_prefill_matches_jax(models):
    jm, tm = models
    spec = jm.spec
    rng = np.random.default_rng(2)
    row = _page_table(1, 6)[0]
    kj, vj, kt, vt = _pools(spec, row.size + 1, rng)
    for start, chunk_len in ((0, 16), (16, 10), (26, 16), (42, 5)):
        tokens = np.zeros((16,), np.int32)
        tokens[:chunk_len] = rng.integers(0, spec.vocab, size=chunk_len)
        kj, vj, lj = jmodel.lm_chunk_prefill(
            jm.params, spec, jnp.asarray(tokens), start, chunk_len, kj, vj,
            jnp.asarray(row), attn_tier="lax")
        lt = tmodel.lm_chunk_prefill(tm.params, spec, _t(tokens), start,
                                     chunk_len, kt, vt, _t(row))
        np.testing.assert_allclose(lt[:chunk_len].numpy(),
                                   np.asarray(lj)[:chunk_len], rtol=TOL,
                                   atol=TOL)
        _close_pools(kt, vt, kj, vj)


def test_lm_decode_matches_jax(models):
    jm, tm = models
    spec = jm.spec
    rng = np.random.default_rng(4)
    pt = _page_table(3, 6)
    kj, vj, kt, vt = _pools(spec, pt.size + 1, rng)
    positions = np.asarray([3, 17, 40], np.int32)
    for _ in range(3):
        tokens = rng.integers(0, spec.vocab, size=3).astype(np.int32)
        kj, vj, lj = jmodel.lm_decode(
            jm.params, spec, jnp.asarray(tokens), jnp.asarray(positions), kj,
            vj, jnp.asarray(pt), attn_tier="lax")
        lt = tmodel.lm_decode(tm.params, spec, _t(tokens), _t(positions), kt,
                              vt, _t(pt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
        _close_pools(kt, vt, kj, vj)
        positions = positions + 1


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_lm_verify_matches_jax(models, models_int8, weights):
    """Every row, padding rows included; a slot at q_len 0 writes
    nothing to its pages."""
    jm, tm = models if weights == "float" else models_int8
    spec = jm.spec
    rng = np.random.default_rng(5)
    pt = _page_table(4, 6)
    kj, vj, kt, vt = _pools(spec, pt.size + 1, rng)
    starts = np.asarray([6, 20, 31, 44], np.int32)
    for q_lens in ([5, 1, 0, 3], [2, 4, 1, 0]):
        q_lens = np.asarray(q_lens, np.int32)
        tokens = rng.integers(0, spec.vocab, size=(4, 5)).astype(np.int32)
        kj, vj, lj = jmodel.lm_verify(
            jm.params, spec, jnp.asarray(tokens), jnp.asarray(starts),
            jnp.asarray(q_lens), kj, vj, jnp.asarray(pt), attn_tier="lax")
        lt = tmodel.lm_verify(tm.params, spec, _t(tokens), _t(starts),
                              _t(q_lens), kt, vt, _t(pt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
        _close_pools(kt, vt, kj, vj)
        starts = starts + q_lens


def test_per_tier_graphs_refuse_code_pools(models):
    _, tm = models
    spec = tm.spec
    shape = (spec.num_layers, 9, PAGE, spec.num_heads, spec.head_dim)
    codes = torch.zeros(shape, dtype=torch.int8)
    pt = torch.arange(1, 9, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="float32 pools"):
        tmodel.lm_decode(tm.params, spec, torch.tensor([1]),
                         torch.tensor([3]), codes, codes, pt)
    with pytest.raises(ValueError, match="float32 pools"):
        tmodel.lm_chunk_prefill(tm.params, spec, torch.zeros(4, dtype=torch.int32),
                                0, 4, codes, codes, pt[0])


# ------------------------------------------------------- per-tier loop


def _sample(logits, sp, index):
    sp = sp or GREEDY
    f32 = dict(dtype=torch.float32)
    return int(_sample_traced(
        logits[None], torch.tensor([sp.seed or 0], dtype=torch.int32),
        torch.tensor([index], dtype=torch.int32),
        torch.tensor([sp.temperature], **f32),
        torch.tensor([sp.top_k], dtype=torch.int32),
        torch.tensor([sp.top_p], **f32))[0])


def per_tier_decode(tm, prompt, n_new, sp, chunk, spec_tokens, counts):
    """One request through the per-tier graphs on a single-slot cache:
    ``lm_chunk_prefill`` in ``chunk``-token chunks, then per step
    ``lm_verify`` on the pending token and its n-gram drafts when there
    are any, else ``lm_decode``. Each token index is sampled with the
    (seed, index) key; a verify step accepts the longest draft prefix
    the target agrees with and emits one token more."""
    spec = tm.spec
    cache = PagedKVCache(CacheConfig(
        num_layers=spec.num_layers, num_heads=spec.num_heads,
        head_dim=spec.head_dim, num_pages=40, page_size=PAGE, max_slots=1,
        max_seq_len=128), device="cpu")
    assert cache.allocate(0, len(prompt) + n_new)
    row = torch.from_numpy(cache.page_table[0].copy())
    kp, vp = cache.k_pool, cache.v_pool
    P = len(prompt)
    for start in range(0, P, chunk):
        n = min(chunk, P - start)
        toks = torch.zeros(chunk, dtype=torch.int32)
        toks[:n] = torch.tensor(prompt[start:start + n])
        logits = tmodel.lm_chunk_prefill(tm.params, spec, toks, start, n, kp,
                                         vp, row)
        counts["chunk"] += 1
    out = [_sample(logits[n - 1], sp, 0)]
    seq = P
    table = row[None]
    while len(out) < n_new:
        draft = ngram_draft(np.asarray(prompt + out, np.int32),
                            min(spec_tokens, n_new - len(out) - 1))
        if not draft:
            logits = tmodel.lm_decode(tm.params, spec,
                                      torch.tensor([out[-1]]),
                                      torch.tensor([seq]), kp, vp, table)
            out.append(_sample(logits[0], sp, len(out)))
            seq += 1
            counts["decode"] += 1
            continue
        T = 1 + len(draft)
        logits = tmodel.lm_verify(
            tm.params, spec, torch.tensor([[out[-1]] + draft]),
            torch.tensor([seq]), torch.tensor([T]), kp, vp, table)[0]
        counts["verify"] += 1
        base = len(out)
        for t in range(T):
            tok = _sample(logits[t], sp, base + t)
            out.append(tok)
            if t == len(draft) or tok != draft[t]:
                break
        seq += len(out) - base
    return out


def test_per_tier_loop_equals_unified_engine(models):
    _, tm = models
    rng = np.random.default_rng(41)
    prefix = rng.integers(0, 128, size=32).tolist()
    prompts = [prefix + rng.integers(0, 128, size=6 + i).tolist()
               for i in range(3)]
    prompts += [np.tile(rng.integers(0, 128, size=5), 8).tolist()[:36],
                rng.integers(0, 128, size=50).tolist()]
    lens = [8, 11, 6, 14, 9]
    sps = [SamplingParams(seed=1),
           SamplingParams(temperature=0.8, top_k=12, seed=2),
           SamplingParams(seed=3),
           SamplingParams(temperature=1.1, top_p=0.9, seed=4),
           SamplingParams(temperature=0.7, top_k=8, top_p=0.95, seed=5)]
    counts = dict(chunk=0, decode=0, verify=0)
    ref = [per_tier_decode(tm, p, n, sp, 16, 4, counts)
           for p, n, sp in zip(prompts, lens, sps)]
    assert counts["verify"] > 0 and counts["decode"] > 0
    s = tm.spec
    eng = GenerationEngine(
        tm, cache_config=CacheConfig(
            num_layers=s.num_layers, num_heads=s.num_heads,
            head_dim=s.head_dim, max_slots=3, max_seq_len=128,
            prefix_cache=True),
        scheduler_config=SchedulerConfig(max_slots=3, min_bucket=8,
                                         max_seq_len=128, chunk_tokens=16,
                                         spec_tokens=4),
        device="cpu")
    rids = [eng.submit(p, n, sp) for p, n, sp in zip(prompts, lens, sps)]
    eng.run()
    assert eng.scheduler.stats["n_spec_steps"] > 0
    assert eng.cache.prefix_hits > 0
    assert [eng.output_of(r) for r in rids] == ref
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0
