"""Quantized serving, the rest: the int8 weight matmul and narrow scale
pools, the port against the JAX package on the same numpy inputs.

- ``model._int8_dot`` (the plain row quantizer and int8 matmul of
  ``kernels/int8.py`` on the CPU) against JAX's ``_int8_dot``: the int32
  sums equal and the float32 results bit for bit (both sides round each
  of the two epilogue multiplies in the same order), for a plain weight
  and the packed ``wqkv [d, 3, H*D]``, at row counts from one to past a
  tile;
- ``quantize_rows`` against JAX's per-row ``quantize_absmax`` bit for
  bit, all-zero rows and a NaN row included;
- ``quantize_kv`` codes and scales bit for bit at float16 and bfloat16
  scales (the codes come from the float32 scale, rounded after);
- the plain ragged attention over narrow scale pools against
  ``ragged_attention_lax`` (rtol = atol = 2e-5, the JAX package's own
  Pallas-tier tolerance) and the Pallas tier in interpret mode;
- the page cost, the content-hash salt (six configs disjoint, the
  digests equal to the JAX cache's) and the swap-key refusal at narrow
  scales and under the int8 matmul; the engine's salt repair (the
  weight-matmul mode reaches the cache config);
- engines: greedy tokens equal to the JAX engine's with
  ``weight_matmul="int8"`` and with bfloat16 scale pools; the
  degrade-to-off rule; tokens identical across runs and chunk budgets;
  teacher-forced logits within the JAX quality bar (mean absolute error
  <= 0.05) of the dequant-first route and of float;
- the swap-store bridges (``held_prefix_pages``, ``publish``/``export``/
  ``import``, ``adopt_swap_store``) and ``load_snapshot`` side by side
  with the JAX cache and scheduler; the quantize/dequantize probe.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from paddle_tpu.inference.llm import (  # noqa: E402
    CacheConfig as JaxCacheConfig, GenerationEngine as JaxEngine, JaxLM,
    PagedKVCache as JaxCache, SchedulerConfig as JaxSchedulerConfig)
from paddle_tpu.inference.llm import model as jmodel  # noqa: E402
from paddle_tpu.inference.llm.quant import (  # noqa: E402
    QuantConfig as JaxQuantConfig, quantize_kv as jax_quantize_kv)
from paddle_tpu.inference.llm.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JaxScheduler)
from paddle_tpu.kernels import int8 as jint8  # noqa: E402
from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    ragged_attention_lax, ragged_attention_pallas)
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu_torch.inference.llm import (  # noqa: E402
    CacheConfig, ContinuousBatchingScheduler, GenerationEngine,
    PagedKVCache, SchedulerConfig, TorchLM)
from paddle_tpu_torch.inference.llm import model as tmodel  # noqa: E402
from paddle_tpu_torch.inference.llm import quant as tquant  # noqa: E402
from paddle_tpu_torch.inference.llm.model import params_from_jax  # noqa: E402
from paddle_tpu_torch.kernels import int8 as tint8  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

H, D, PAGE = 2, 16, 8
TOL = 2e-5
# the JAX package's quantized-serving quality bar (bench_serving's
# QUANT_MAE_MAX, tests/test_coll_quant.py)
MAE_MAX = 0.05
NARROW = {"float16": (torch.float16, np.float16),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _rows(seed, m, k):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 30.0], size=(m, 1)).astype(np.float32)
    if m > 2:
        x[1] = 0.0                       # the scale floor: zero codes
        x[2, 3] = 1e4                    # one huge value among small ones
    return x


# ------------------------------------------------------ int8 matmul --

def _transposed(wq):
    """JAX's ``[K, ...]`` weight codes in the port's int8-matmul layout,
    ``[N, K]`` (``TorchLM.with_int8_matmul_layout``)."""
    q = np.array(wq)
    return torch.from_numpy(q.reshape(q.shape[0], -1).T.copy())


@pytest.mark.parametrize("m", [1, 8, 9, 40])
@pytest.mark.parametrize("packed", [False, True])
def test_int8_dot_bit_for_bit(m, packed):
    """Port ``_int8_dot`` (plain quantizer and matmul) against JAX's on
    the same activations and int8 weights: float32 results bit-equal."""
    rng = np.random.default_rng(m + 10 * packed)
    x = _rows(m, m, 32)
    shape = (32, 3, 48) if packed else (32, 96)
    w = (0.02 * rng.normal(size=shape)).astype(np.float32)
    wq, ws = jint8.quantize_absmax(jnp.asarray(w), axis=0)
    want = np.asarray(jmodel._int8_dot(jnp.asarray(x), wq, ws))
    got = tmodel._int8_dot(torch.from_numpy(x), _transposed(wq),
                           torch.from_numpy(np.array(ws))).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [32, 128, 2048])
def test_int8_matmul_int32_sums_equal(k):
    """The plain matmul's float64 sums are the int32 sums JAX's
    ``dot_general(preferred_element_type=int32)`` forms, exactly, up to
    the largest |sum| a K of 2048 allows."""
    rng = np.random.default_rng(k)
    xq = rng.integers(-127, 128, size=(5, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, 24)).astype(np.int8)
    xq[0] = 127
    wq[:, 0] = 127                      # the largest sum: k * 127^2
    want = np.asarray(jnp.asarray(xq).astype(jnp.int32)
                      @ jnp.asarray(wq).astype(jnp.int32))
    ones = torch.ones(5, 1)
    got = tint8.int8_matmul_ref(torch.from_numpy(xq), ones,
                                torch.from_numpy(wq.T.copy()),
                                torch.ones(24))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert want[0, 0] == k * 127 * 127


@pytest.mark.parametrize("seed", range(3))
def test_quantize_rows_bit_for_bit(seed):
    x = _rows(seed, 12, 64)
    wq, ws = jint8.quantize_absmax(jnp.asarray(x), axis=-1)
    q, s = tint8.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert q.dtype == torch.int8 and s.shape == (12, 1)


def test_nan_row_poisons_its_outputs_only():
    """A NaN in a row makes that row's scale NaN and its products NaN,
    as in JAX (the engine's device-fault boundary reads non-finite
    logits); the other rows stay finite and equal JAX's."""
    x = _rows(4, 6, 32)
    x[3, 7] = np.nan
    w = (0.02 * np.random.default_rng(0).normal(size=(32, 16))
         ).astype(np.float32)
    wq, ws = jint8.quantize_absmax(jnp.asarray(w), axis=0)
    want = np.asarray(jmodel._int8_dot(jnp.asarray(x), wq, ws))
    got = tmodel._int8_dot(torch.from_numpy(x), _transposed(wq),
                           torch.from_numpy(np.array(ws))).numpy()
    assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
    keep = [0, 1, 2, 4, 5]
    np.testing.assert_array_equal(got[keep], want[keep])


def test_int8_kernels_refuse_cpu_tensors_and_bad_shapes():
    x = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tint8.quantize_rows_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tint8.int8_matmul_cuda(torch.zeros(2, 32, dtype=torch.int8),
                               torch.ones(2, 1),
                               torch.zeros(4, 32, dtype=torch.int8),
                               torch.ones(4))


def test_int8_matmul_layout_is_a_transpose():
    """``TorchLM.with_int8_matmul_layout`` replaces every ``@q`` by its
    transpose ``@qt [N, K]`` (one copy of the codes; the scales and the
    float weights shared), idempotently; ``_int8_dot`` on it equals
    JAX's on the ``[K, ...]`` codes bit for bit; a float model comes
    back as it is. ``quant.prepare_model`` makes this layout for the
    int8 matmul only, and refuses to serve it dequant-first."""
    jm = JaxLM.tiny(seed=2).quantize_weights()
    tm = TorchLM(jm.spec, params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu"),
        device="cpu")
    lay = tm.with_int8_matmul_layout()
    assert lay.with_int8_matmul_layout() is lay
    assert lay.quantize_weights() is lay
    for name in tquant.quantized_weight_names(tm.spec):
        q = tm.params[name + "@q"]
        qt = lay.params[name + "@qt"]
        assert qt.is_contiguous()
        assert torch.equal(qt, q.reshape(q.shape[0], -1).t())
        assert name + "@q" not in lay.params
        assert lay.params[name + "@s"] is tm.params[name + "@s"]
    x = _rows(5, 7, tm.spec.d_model)
    p = lay.params
    want = np.asarray(jmodel._int8_dot(jnp.asarray(x),
                                       jm.params["l0.wqkv@q"],
                                       jm.params["l0.wqkv@s"]))
    got = tmodel._int8_dot(torch.from_numpy(x), p["l0.wqkv@qt"],
                           p["l0.wqkv@s"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert TorchLM.tiny(device="cpu").with_int8_matmul_layout().params \
        .keys() == TorchLM.tiny(device="cpu").params.keys()
    wm = tquant.QuantConfig(weights="int8", weight_matmul="int8")
    off = tquant.QuantConfig(weights="int8")
    assert tquant.prepare_model(tm, wm).params.keys() == p.keys()
    assert tquant.prepare_model(tm, off) is tm
    assert tquant.prepare_model(tm, None) is tm
    with pytest.raises(ValueError, match="int8 matmul's layout"):
        tquant.prepare_model(lay, off)


# ---------------------------------------------------- narrow scales --

@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("scale_dtype", list(NARROW))
def test_quantize_kv_narrow_scales_bit_for_bit(mode, scale_dtype):
    x = _rows(7, 40, D).reshape(5, 4, 2, D)
    jq, js = jax_quantize_kv(jnp.asarray(x), mode, scale_dtype)
    tq, ts = tquant.quantize_kv(torch.from_numpy(x), mode, scale_dtype)
    assert ts.dtype == NARROW[scale_dtype][0]
    codes = tq.view(torch.uint8) if mode == "fp8" else tq
    want_codes = np.asarray(jq).view(np.uint8) if mode == "fp8" \
        else np.asarray(jq)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(
        ts.to(torch.float32).numpy(),
        np.asarray(js).astype(np.float32))
    # the codes come from the float32 scale: the same codes as float32
    f32_q, _ = tquant.quantize_kv(torch.from_numpy(x), mode, "float32")
    assert torch.equal(tq.view(torch.uint8) if mode == "fp8" else tq,
                       f32_q.view(torch.uint8) if mode == "fp8" else f32_q)


def _narrow_mix(seed, mode, scale_dtype, pages_per_seq=4, n_pool_pages=32):
    """A ragged mix over pools quantized by the JAX package with narrow
    scales: (jax args, torch args)."""
    rng = np.random.default_rng(seed)
    q_lens = [1, 8, 4, 0, 1, 6]
    kv_lens = [max(int(rng.integers(ql, pages_per_seq * PAGE)), ql)
               if ql else 0 for ql in q_lens]
    free = list(range(1, n_pool_pages))
    rng.shuffle(free)
    pt = np.array([[free.pop() for _ in range(pages_per_seq)]
                   for _ in q_lens], np.int32)
    q_starts = np.cumsum([0] + q_lens[:-1]).astype(np.int32)
    n = int(sum(q_lens)) + 5
    kf = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32)
    vf = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32) * 3
    kq, ks = jax_quantize_kv(jnp.asarray(kf), mode, scale_dtype)
    vq, vs = jax_quantize_kv(jnp.asarray(vf), mode, scale_dtype)
    q = rng.normal(size=(n, H, D)).astype(np.float32)
    rows = (pt, np.asarray(kv_lens, np.int32), q_starts,
            np.asarray(q_lens, np.int32))

    def codes(c):
        a = np.asarray(c)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy())
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)

    def scales(s):
        return torch.from_numpy(np.asarray(s).astype(np.float32)).to(
            NARROW[scale_dtype][0])

    jax_args = ([jnp.asarray(q), kq, vq] + [jnp.asarray(a) for a in rows],
                dict(k_scale=ks, v_scale=vs))
    torch_args = ([torch.from_numpy(q), codes(kq), codes(vq)]
                  + [torch.from_numpy(a) for a in rows],
                  dict(k_scale=scales(ks), v_scale=scales(vs)))
    return jax_args, torch_args


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("scale_dtype", list(NARROW))
def test_narrow_scale_ref_matches_lax(mode, scale_dtype):
    (ja, jkw), (ta, tkw) = _narrow_mix(3, mode, scale_dtype)
    assert tkw["k_scale"].dtype == NARROW[scale_dtype][0]
    want = np.asarray(ragged_attention_lax(*ja, **jkw))
    got = pa.ragged_attention_ref(*ta, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    split = pa.ragged_attention_ref_split(*ta, split_pages=2, **tkw).numpy()
    np.testing.assert_allclose(split, want, rtol=TOL, atol=TOL)
    n_used = int(ta[-1].sum())
    assert (got[n_used:] == 0.0).all()


def test_narrow_scale_ref_matches_pallas_interpret():
    (ja, jkw), (ta, tkw) = _narrow_mix(5, "int8", "bfloat16")
    want = np.asarray(ragged_attention_pallas(*ja, interpret=True, **jkw))
    got = pa.ragged_attention(*ta, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_narrow_scale_kernel_names_and_refusals():
    """Each (code, scale dtype) pair names its own library and launch
    key; the kernel tier refuses CPU tensors and mixed scale dtypes."""
    names = set(pa.NARROW_KERNEL_NAMES)
    assert len(names) == 8 and not names & set(pa.KERNEL_NAMES)
    assert pa.kernel_name(torch.int8, False, torch.float32) == \
        pa.kernel_name(torch.int8, False)
    _, (ta, tkw) = _narrow_mix(1, "int8", "float16")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.ragged_attention(*ta, tier="kernel", **tkw)


@pytest.mark.parametrize("scale_dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_page_cost_counts_the_scale_itemsize(kv_quant, scale_dtype):
    geom = dict(num_layers=3, num_heads=4, head_dim=16, num_pages=40,
                page_size=8, max_slots=4, max_seq_len=256,
                kv_quant=kv_quant, scale_dtype=scale_dtype)
    t = CacheConfig(**geom)
    j = JaxCacheConfig(swap_pages=0, **geom)
    assert t.page_bytes() == j.page_bytes()
    c = PagedKVCache(CacheConfig(swap_pages=0, **geom), device="cpu")
    assert c.k_scale.dtype == tquant.SCALE_DTYPES[scale_dtype]
    assert c.v_scale.dtype == c.k_scale.dtype


# --------------------------------------------------- salt and swaps --

SALT_CONFIGS = (("off", "float32", "off", "off"),
                ("int8", "float32", "off", "off"),
                ("fp8", "float32", "off", "off"),
                ("int8", "float16", "off", "off"),
                ("int8", "float32", "int8", "off"),
                ("off", "float32", "int8", "off"),
                ("int8", "bfloat16", "int8", "int8"),
                ("off", "float32", "int8", "int8"))


def _salt_caches(kv, sd, wq, wm):
    kw = dict(num_layers=1, num_heads=2, head_dim=8, num_pages=8,
              page_size=4, max_slots=1, max_seq_len=16, kv_quant=kv,
              scale_dtype=sd, weight_quant=wq, weight_matmul=wm)
    return (PagedKVCache(CacheConfig(**kw), device="cpu"),
            JaxCache(JaxCacheConfig(**kw)))


def test_salted_digests_disjoint_and_equal_to_jax():
    """The JAX test's six configs plus two with the int8 matmul: every
    digest distinct, and each equal to the JAX cache's digest."""
    toks = list(range(8))
    digests = set()
    for cfg in SALT_CONFIGS:
        t, j = _salt_caches(*cfg)
        assert t._block_hashes(toks) == j._block_hashes(toks), cfg
        assert t.swap_quant_key == j.swap_quant_key
        digests.add(t._block_hashes(toks)[0])
    assert len(digests) == len(SALT_CONFIGS)


def test_engine_aligns_weight_matmul_into_the_cache(models):
    """The salt repair: an engine with the int8 weight matmul keys its
    prefix cache and swap store apart from a dequant-first engine (the
    JAX engine aligns ``weight_matmul`` into its cache config; both
    sides' digests agree)."""
    jm, tm = models
    toks = list(range(24))
    digests = {}
    for wm in ("off", "int8"):
        q = tquant.QuantConfig(kv="int8", weights="int8", weight_matmul=wm)
        te = GenerationEngine(tm, cache_config=CacheConfig(**GEOM),
                              scheduler_config=SchedulerConfig(**SCHED),
                              quant=q, device="cpu")
        je = JaxEngine(jm, cache_config=JaxCacheConfig(**GEOM),
                       scheduler_config=JaxSchedulerConfig(**SCHED),
                       quant=JaxQuantConfig(kv="int8", weights="int8",
                                            weight_matmul=wm))
        assert te.cache.config.weight_matmul == wm
        assert te.cache.swap_quant_key == je.cache.swap_quant_key
        digests[wm] = te.cache._block_hashes(toks)
        assert digests[wm] == je.cache._block_hashes(toks)
    assert all(a != b for a, b in zip(digests["off"], digests["int8"]))


def test_adoption_refused_across_quant_configs():
    kw = dict(num_layers=1, num_heads=2, head_dim=8, num_pages=16,
              page_size=4, max_slots=2, max_seq_len=32, kv_quant="int8")
    toks = list(range(8))
    a = PagedKVCache(CacheConfig(**kw), device="cpu")
    for other in (dict(weight_quant="int8"), dict(scale_dtype="bfloat16"),
                  dict(weight_quant="int8", weight_matmul="int8")):
        b = PagedKVCache(CacheConfig(**kw, **other), device="cpu")
        assert a.allocate(0, 8, prompt=toks)
        a.seq_lens[0] = 8
        a.swap_out(0, toks)
        a.release(0)
        assert b.adopt_swap_store(a) == 0      # refused, not carried
    same = PagedKVCache(CacheConfig(**kw), device="cpu")
    assert same.adopt_swap_store(a) == a.num_swapped_pages == 2


def _filled(cache, toks, slot=0):
    assert cache.allocate(slot, len(toks), prompt=toks)
    cache.seq_lens[slot] = len(toks)
    return cache


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_swap_bridges_side_by_side(scale_dtype):
    """``publish_prefix_pages`` -> ``export_swap_entries`` ->
    ``import_swap_entries`` -> ``held_prefix_pages`` on the port and the
    JAX cache in lockstep (same counts at each step); the imported
    entries restore byte for byte through ``swap_in``, scales in their
    stored dtype."""
    kw = dict(num_layers=2, num_heads=2, head_dim=8, num_pages=16,
              page_size=4, max_slots=2, max_seq_len=32, kv_quant="int8",
              scale_dtype=scale_dtype, swap_pages=8)
    toks = list(range(3, 17))                   # 3 full pages + 2
    src_t = PagedKVCache(CacheConfig(**kw), device="cpu")
    src_j = JaxCache(JaxCacheConfig(**kw))
    gen = torch.Generator().manual_seed(0)
    src_t.k_pool.copy_(torch.randint(-127, 128, src_t.k_pool.shape,
                                     generator=gen, dtype=torch.int8))
    src_t.k_scale.copy_(torch.rand(src_t.k_scale.shape, generator=gen))
    for c in (src_t, src_j):
        _filled(c, toks)
        c.commit_prefix(0, toks)
        c.release(0)
    hashes = src_t._block_hashes(toks)
    assert hashes == src_j._block_hashes(toks)
    assert src_t.held_prefix_pages(hashes) == \
        src_j.held_prefix_pages(hashes) == 3
    assert src_t.publish_prefix_pages(toks, hashes) == \
        src_j.publish_prefix_pages(toks, hashes) == 3
    assert src_t.publish_prefix_pages(toks, hashes) == 0
    ent_t = src_t.export_swap_entries(hashes)
    ent_j = src_j.export_swap_entries(hashes)
    assert list(ent_t) == list(ent_j) == hashes[:3]
    assert ent_t[hashes[0]][2].dtype == tquant.SCALE_DTYPES[scale_dtype]
    dst_t = PagedKVCache(CacheConfig(**kw), device="cpu")
    dst_j = JaxCache(JaxCacheConfig(**kw))
    assert dst_t.import_swap_entries(ent_t) == \
        dst_j.import_swap_entries(ent_j) == 3
    assert dst_t.import_swap_entries(ent_t) == 0
    assert dst_t.held_prefix_pages(hashes) == \
        dst_j.held_prefix_pages(hashes) == 3
    _filled(dst_t, toks)
    assert dst_t.swap_in(0, toks) == 3
    page = dst_t.page_table[0, 0]
    assert torch.equal(dst_t.k_pool[:, page], ent_t[hashes[0]][0])
    assert torch.equal(dst_t.k_scale[:, page], ent_t[hashes[0]][2])
    src_page = src_t._prefix_map[hashes[0]]
    assert torch.equal(dst_t.k_scale[:, page], src_t.k_scale[:, src_page])
    dst_t.check_invariants()


def test_load_snapshot_matches_jax():
    kw = dict(num_layers=1, num_heads=2, head_dim=8, num_pages=32,
              page_size=4, max_slots=2, max_seq_len=32)
    sch_kw = dict(max_slots=2, max_seq_len=32)
    t = ContinuousBatchingScheduler(PagedKVCache(CacheConfig(**kw),
                                                 device="cpu"),
                                    SchedulerConfig(**sch_kw))
    j = JaxScheduler(JaxCache(JaxCacheConfig(**kw)),
                     JaxSchedulerConfig(**sch_kw))
    for s in (t, j):
        for n in (5, 9, 3):
            s.submit(list(range(1, n + 1)), 4)
    assert t.load_snapshot() == j.load_snapshot()
    t.step_plan()
    j.step_plan()
    assert t.load_snapshot() == j.load_snapshot()
    assert set(t.load_snapshot()) == {"queue_depth", "running",
                                      "pages_in_use", "free_pages"}


def test_quant_probe_times_and_observes():
    secs = tquant.time_quant_roundtrip("int8", 8, 2, 16)
    assert 0.0 < secs < 5.0
    eng = GenerationEngine(TorchLM.tiny(device="cpu"),
                           scheduler_config=SchedulerConfig(
                               max_slots=2, max_seq_len=64),
                           quant=tquant.QuantConfig(kv="int8"),
                           device="cpu")
    fam = tobs.serving_metrics()["quant_dequant"]
    before = fam.count
    eng.generate([[1, 2, 3, 4]], 3)
    assert fam.count > before


# ------------------------------------------------------------ engines --

GEOM = dict(num_layers=2, num_heads=2, head_dim=16, num_pages=64,
            page_size=8, max_slots=4, max_seq_len=128, prefix_cache=True,
            swap_pages=0, demote_cold_prefix=False)
SCHED = dict(max_slots=4, max_seq_len=128)
NEW = 8


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny()
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TorchLM(jm.spec, params_from_jax(np_params, "cpu"),
                       device="cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128, size=24).tolist()
    return [shared + rng.integers(0, 128, size=5).tolist(),
            rng.integers(0, 128, size=17).tolist(),
            shared + rng.integers(0, 128, size=9).tolist(),
            rng.integers(0, 128, size=3).tolist()]


QUANTS = {"wm_int8": dict(weights="int8", weight_matmul="int8"),
          "wm_int8_kv_int8": dict(kv="int8", weights="int8",
                                  weight_matmul="int8"),
          "kv_int8_bf16": dict(kv="int8", scale_dtype="bfloat16"),
          "kv_fp8_f16_wm": dict(kv="fp8", scale_dtype="float16",
                                weights="int8", weight_matmul="int8")}


@pytest.mark.parametrize("chunk_tokens", [0, 8])
@pytest.mark.parametrize("qname", list(QUANTS))
def test_engine_tokens_equal_jax(models, qname, chunk_tokens):
    jm, tm = models
    sched = dict(SCHED, chunk_tokens=chunk_tokens)
    je = JaxEngine(jm, cache_config=JaxCacheConfig(**GEOM),
                   scheduler_config=JaxSchedulerConfig(**sched),
                   quant=JaxQuantConfig(**QUANTS[qname]))
    te = GenerationEngine(tm, cache_config=CacheConfig(**GEOM),
                          scheduler_config=SchedulerConfig(**sched),
                          quant=tquant.QuantConfig(**QUANTS[qname]),
                          device="cpu")
    want = je.generate(_prompts(), NEW)
    got = te.generate(_prompts(), NEW)
    assert got == want
    assert te.cache.prefix_hits == je.cache.prefix_hits > 0
    te.cache.check_invariants()


def test_weight_matmul_degrades_without_int8_weights(models):
    """``weight_matmul="int8"`` without ``weights="int8"`` has nothing to
    multiply: it degrades to off, and an all-off result is ``None``
    (JAX ``test_engine_resolution_rules``); a scheduler knob reaches the
    engine as on the JAX side."""
    _, tm = models
    eng = GenerationEngine(tm, scheduler_config=SchedulerConfig(**SCHED),
                           quant=tquant.QuantConfig(weight_matmul="int8"),
                           device="cpu")
    assert eng.quant is None
    assert eng.cache.config.weight_matmul == "off"
    eng = GenerationEngine(tm, scheduler_config=SchedulerConfig(
        weight_quant="int8", weight_matmul="int8", **SCHED), device="cpu")
    assert eng.quant.weight_matmul == "int8"
    assert "l0.wqkv@qt" in eng.model.params
    assert "l0.wqkv@q" not in eng.model.params
    eng = GenerationEngine(tm, scheduler_config=SchedulerConfig(
        kv_quant="int8", weight_matmul="int8", **SCHED), device="cpu")
    assert eng.quant.weight_matmul == "off" and eng.quant.kv == "int8"


def test_weight_matmul_engine_deterministic(models):
    """Tokens identical across two runs and across chunk budgets (JAX
    ``test_weight_matmul_engine_deterministic``)."""
    _, tm = models
    q = tquant.QuantConfig(weights="int8", weight_matmul="int8")
    outs = []
    for chunk in (0, 0, 16):
        te = GenerationEngine(tm, cache_config=CacheConfig(**GEOM),
                              scheduler_config=SchedulerConfig(
                                  chunk_tokens=chunk, **SCHED),
                              quant=q, device="cpu")
        outs.append(te.generate(_prompts(3), NEW))
    assert outs[0] == outs[1] == outs[2]


def _teacher_forced(tm, prompt, quant):
    """One prefill step's logits through ``lm_ragged_step`` on a fresh
    cache (the JAX test's ``_teacher_forced_logits``), the weights
    prepared for ``quant`` as an engine prepares them."""
    tm = tquant.prepare_model(tm, quant)
    s = tm.spec
    cc = CacheConfig(num_layers=s.num_layers, num_heads=s.num_heads,
                     head_dim=s.head_dim, num_pages=32, page_size=8,
                     max_slots=1, max_seq_len=128, swap_pages=0)
    cc = tquant.align_cache_config(cc, quant)
    cache = PagedKVCache(cc, device="cpu")
    n = len(prompt)
    assert cache.allocate(0, n)
    i32 = dict(dtype=torch.int32)
    return tmodel.lm_ragged_step(
        tm.params, s, torch.tensor(prompt, **i32), torch.zeros(1, **i32),
        torch.tensor([n], **i32), torch.tensor([n], **i32), cache.k_pool,
        cache.v_pool, torch.from_numpy(np.array(cache.page_table)),
        k_scale=cache.k_scale,
        v_scale=cache.v_scale, quant=quant).numpy()


def test_weight_matmul_quality_vs_dequant_first_and_float(models):
    """Teacher-forced logits of the int8 matmul within the JAX quality
    bar (MAE <= 0.05) of the dequant-first route and of float, and the
    port's int8-matmul logits equal to the JAX step's at 1e-4 (float32
    matmul order differs between the backends in the attention)."""
    jm, tm = models
    prompt = np.random.default_rng(29).integers(0, 128, size=48).tolist()
    dequant = _teacher_forced(tm, prompt, tquant.QuantConfig(weights="int8"))
    wm = tquant.QuantConfig(weights="int8", weight_matmul="int8")
    mxu = _teacher_forced(tm, prompt, wm)
    ref = _teacher_forced(tm, prompt, None)
    assert 0.0 < float(np.mean(np.abs(mxu - dequant))) <= MAE_MAX
    assert float(np.mean(np.abs(mxu - ref))) <= MAE_MAX
    qjm = jm.quantize_weights()
    s = jm.spec
    jcache = JaxCache(JaxCacheConfig(
        num_layers=s.num_layers, num_heads=s.num_heads, head_dim=s.head_dim,
        num_pages=32, page_size=8, max_slots=1, max_seq_len=128,
        swap_pages=0, weight_quant="int8", weight_matmul="int8"))
    n = len(prompt)
    assert jcache.allocate(0, n)
    out = jmodel.lm_ragged_step(
        qjm.params, s, jnp.asarray(prompt, jnp.int32),
        jnp.zeros((1,), jnp.int32), jnp.asarray([n], jnp.int32),
        jnp.asarray([n], jnp.int32), jcache.k_pool, jcache.v_pool,
        jnp.asarray(jcache.page_table),
        quant=JaxQuantConfig(weights="int8", weight_matmul="int8"))
    np.testing.assert_allclose(mxu, np.asarray(out[4]), rtol=1e-4,
                               atol=1e-4)
