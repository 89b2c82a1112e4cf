"""The port's flash-decode KV split and two-level page table against
the JAX reference.

- ``ragged_attention_ref_split`` (the plain version the split kernels
  are held against on the card) against ``ragged_attention_lax_split``
  and against the Pallas split kernel in interpret mode, for split
  widths 1, 2, 3 over float32, int8 and fp8 pools, at the JAX package's
  Pallas-tier tolerance (rtol = atol = 2e-5, float32);
- the dispatcher on CPU tensors is split-invariant bit for bit (the
  split is a kernel schedule, inert on the plain path, as on the JAX
  side's gather tier);
- the two-level page table: the same operation sequence on both caches
  gives equal ``allocate`` results, flat page tables, directories and
  index pools — including the refusal when index rows run out before
  pages do — and ``flatten_page_levels`` rebuilds the flat view.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm.kv_cache import (  # noqa: E402
    CacheConfig as JaxCacheConfig, PagedKVCache as JaxCache,
    flatten_page_levels as jax_flatten)
from paddle_tpu.inference.llm.quant import (  # noqa: E402
    quantize_kv as jax_quantize_kv)
from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    ragged_attention_lax, ragged_attention_lax_split,
    ragged_attention_pallas)
from paddle_tpu_torch.inference.llm.kv_cache import (  # noqa: E402
    CacheConfig, PagedKVCache, flatten_page_levels)
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

H, D, PAGE = 2, 16, 8
TOL = 2e-5
PAGES_PER_SEQ = 8


def _codes_torch(codes):
    arr = np.asarray(codes)
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    return torch.from_numpy(arr.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


def _mix(seed, mode, pad=4, n_pool_pages=64):
    """Chunk, decode, verify-shaped, idle and long-decode rows over an
    8-page table (so split widths 1, 2 and 3 all cut real chunks, and
    3 pads the table to 9 columns), float32 or quantized pools."""
    rng = np.random.default_rng(seed)
    q_lens = [8, 1, 4, 0, 1, 5]
    S = PAGES_PER_SEQ * PAGE
    kv_lens = [max(ql, int(rng.integers(ql, S))) if ql else 0
               for ql in q_lens]
    kv_lens[4] = S                       # a row over the whole table
    free = list(range(1, n_pool_pages))
    rng.shuffle(free)
    pt = np.array([[free.pop() for _ in range(PAGES_PER_SEQ)]
                   for _ in q_lens], np.int32)
    q_starts = np.cumsum([0] + q_lens[:-1]).astype(np.int32)
    n = int(sum(q_lens)) + pad
    kf = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32)
    vf = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32)
    q = rng.normal(size=(n, H, D)).astype(np.float32)
    rows = [pt, np.asarray(kv_lens, np.int32), q_starts,
            np.asarray(q_lens, np.int32)]
    if mode == "f32":
        jpools, tpools, jkw, tkw = ([jnp.asarray(kf), jnp.asarray(vf)],
                                    [torch.from_numpy(kf),
                                     torch.from_numpy(vf)], {}, {})
    else:
        kq, ks = jax_quantize_kv(jnp.asarray(kf), mode)
        vq, vs = jax_quantize_kv(jnp.asarray(vf), mode)
        jpools, jkw = [kq, vq], dict(k_scale=ks, v_scale=vs)
        tpools = [_codes_torch(kq), _codes_torch(vq)]
        tkw = dict(k_scale=torch.from_numpy(np.array(ks)),
                   v_scale=torch.from_numpy(np.array(vs)))
    ja = [jnp.asarray(q)] + jpools + [jnp.asarray(a) for a in rows]
    ta = [torch.from_numpy(q)] + tpools + [torch.from_numpy(a) for a in rows]
    return (ja, jkw), (ta, tkw)


MODES = ["f32", "int8", "fp8"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sp", [1, 2, 3])
@pytest.mark.parametrize("seed", range(2))
def test_ref_split_matches_lax_split(mode, sp, seed):
    (ja, jkw), (ta, tkw) = _mix(seed, mode)
    want = np.asarray(ragged_attention_lax_split(*ja, sp, **jkw))
    got = pa.ragged_attention_ref_split(*ta, sp, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    n_used = int(ta[-1].sum())
    assert (got[n_used:] == 0.0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sp", [1, 2, 3])
def test_ref_split_matches_pallas_split_interpret(mode, sp):
    (ja, jkw), (ta, tkw) = _mix(7, mode)
    want = np.asarray(ragged_attention_pallas(*ja, split_pages=sp,
                                              interpret=True, **jkw))
    got = pa.ragged_attention_ref_split(*ta, sp, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the split is a schedule of the same attention
    unsplit = pa.ragged_attention_ref(*ta, **tkw).numpy()
    np.testing.assert_allclose(got, unsplit, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sp", [0, -1, PAGES_PER_SEQ, 20])
def test_ref_split_degrades_to_unsplit_exactly(sp):
    (ja, jkw), (ta, tkw) = _mix(3, "int8")
    got = pa.ragged_attention_ref_split(*ta, sp, **tkw)
    assert torch.equal(got, pa.ragged_attention_ref(*ta, **tkw))
    want = np.asarray(ragged_attention_lax(*ja, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sp", [1, 2, 3, 16])
def test_dispatcher_on_cpu_is_split_invariant_bitwise(mode, sp):
    _, (ta, tkw) = _mix(11, mode)
    off = pa.ragged_attention(*ta, split_pages=0, **tkw)
    on = pa.ragged_attention(*ta, split_pages=sp, **tkw)
    assert torch.equal(on, off)
    assert sum(pa.LAUNCHES.values()) == 0


def test_split_active_bounds():
    assert not pa.split_active(0, 8)
    assert pa.split_active(1, 8) and pa.split_active(7, 8)
    assert not pa.split_active(8, 8)
    assert pa.kernel_name(torch.int8, True) == "ragged_attention_split_int8"
    assert pa.kernel_name(torch.float32, False) == "ragged_attention"
    assert len(set(pa.KERNEL_NAMES)) == 6


# ------------------------------------------------------ two-level table --

GEOM = dict(num_layers=2, num_heads=2, head_dim=8, num_pages=33,
            page_size=4, max_slots=5, max_seq_len=64, prefix_cache=True,
            swap_pages=0, demote_cold_prefix=False)


def _caches(**over):
    geom = {**GEOM, **over}
    return (JaxCache(JaxCacheConfig(**geom)),
            PagedKVCache(CacheConfig(**geom), device="cpu"))


def _tables(cache):
    return (np.asarray(cache.page_table).tolist(), cache.slot_dir.tolist(),
            cache.index_pool.tolist(), sorted(cache._dir_free),
            sorted(cache._free), cache.slot_page_capacity,
            cache.page_table_version)


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_index_row_exhaustion_refuses_like_the_reference(kv_quant):
    """Heavy prefix sharing exhausts the directory's index rows while
    pages remain: both caches refuse the fifth slot without mutating
    anything, and a release makes the rows reusable."""
    j, t = _caches(kv_quant=kv_quant)
    assert t.config.dir_fanout == 8 and t.config.dir_entries == 2
    prefix = list(range(100, 132))                   # 8 full pages
    p0 = prefix + [0, 1, 2, 3]                       # 9 pages -> 2 rows
    script = [("alloc", 0, 36, p0), ("commit", 0, p0)]
    script += [("alloc", s, 36, prefix + [s] * 4) for s in (1, 2, 3)]
    script += [("alloc", 4, 36, prefix + [9] * 4), ("release", 0),
               ("alloc", 4, 36, prefix + [9] * 4), ("release", 2),
               ("alloc", 0, 13, None), ("release", 4)]
    results = []
    for op in script:
        got = {}
        for name, cache in (("jax", j), ("torch", t)):
            if op[0] == "alloc":
                got[name] = (cache.can_allocate(op[2], prompt=op[3]),
                             cache.allocate(op[1], op[2], prompt=op[3]))
                if got[name][1]:
                    cache.seq_lens[op[1]] = op[2]
            elif op[0] == "commit":
                cache.commit_prefix(op[1], op[2])
            else:
                cache.release(op[1])
            cache.check_invariants()
        assert got.get("torch") == got.get("jax"), op
        assert _tables(t) == _tables(j), op
        if op[0] == "alloc":
            results.append(got["torch"][1])
    # the first fifth-slot allocation was refused for rows, not pages
    assert results == [True, True, True, True, False, True, True]
    assert t._prefix_map == j._prefix_map


def test_flatten_page_levels_matches_reference_and_flat_view():
    j, t = _caches()
    for cache in (j, t):
        assert cache.allocate(0, 13)
        assert cache.allocate(2, 40, prompt=list(range(40)))
        assert cache.allocate(3, 64)
    slot_dir, index_pool = t.device_page_levels()
    flat = flatten_page_levels(slot_dir, index_pool,
                               t.config.pages_per_seq)
    assert flat.dtype == torch.int32
    want = jax_flatten(jnp.asarray(j.slot_dir), jnp.asarray(j.index_pool),
                       j.config.pages_per_seq)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    np.testing.assert_array_equal(flat.numpy(), t.page_table)
    with pytest.raises(ValueError):
        t.page_table[0, 0] = 3                       # read-only view


@pytest.mark.parametrize("max_seq_len,page_size", [(64, 16), (1000, 16),
                                                   (200, 16), (64, 4)])
def test_flat_page_table_is_contiguous(max_seq_len, page_size):
    """Where the directory spans more columns than ``pages_per_seq``
    (4 pages in 8 columns, 63 in 64, 13 in 16) the flat view is still a
    contiguous table equal to the JAX flattening: the CUDA kernels take
    no strided page table."""
    j, t = _caches(max_seq_len=max_seq_len, page_size=page_size,
                   num_pages=129)
    for cache in (j, t):
        assert cache.allocate(0, max_seq_len)
        assert cache.allocate(3, max_seq_len // 3, prompt=[7] * 5)
    slot_dir, index_pool = t.device_page_levels()
    flat = flatten_page_levels(slot_dir, index_pool, t.config.pages_per_seq)
    assert flat.is_contiguous()
    assert flat.shape == (t.config.max_slots, t.config.pages_per_seq)
    want = jax_flatten(jnp.asarray(j.slot_dir), jnp.asarray(j.index_pool),
                       j.config.pages_per_seq)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    np.testing.assert_array_equal(flat.numpy(), t.page_table)


@pytest.mark.parametrize("max_seq_len,num_pages", [(64, 33), (2048, 1025),
                                                   (200, 9)])
def test_capacity_and_geometry_match(max_seq_len, num_pages):
    j, t = _caches(max_seq_len=max_seq_len, num_pages=num_pages,
                   page_size=16)
    assert t.slot_page_capacity == j.slot_page_capacity
    assert t.index_pool.shape == j.index_pool.shape
    assert t.slot_dir.shape == j.slot_dir.shape
