"""The port's quantized serving primitives against the JAX reference.

- ``kernels.int8.quantize_absmax`` / ``dequantize``, ``quant.quantize_kv``
  (int8, fp8) and ``quant.quantize_lm_weights``: codes and scales equal
  bit for bit, including all-zero rows (scale floor, zero codes) and
  rows that land on the e4m3 range edge of +-448;
- ``ragged_attention_ref`` over int8 / fp8 code pools with float32
  scale pools against ``ragged_attention_lax`` and against the Pallas
  tier in interpret mode, at the JAX package's own Pallas-tier
  tolerance (rtol = atol = 2e-5, float32);
- the quant config surface: validation, the page cost, and weights
  carried across from ``JaxLM.quantize_weights()`` keeping their dtypes.

fp8 codes are compared as their raw bytes (``uint8`` views).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm.kv_cache import (  # noqa: E402
    CacheConfig as JaxCacheConfig)
from paddle_tpu.inference.llm.model import JaxLM  # noqa: E402
from paddle_tpu.inference.llm.quant import (  # noqa: E402
    dequantize_kv as jax_dequantize_kv, quantize_kv as jax_quantize_kv,
    quantize_lm_weights as jax_quantize_lm_weights)
from paddle_tpu.kernels import int8 as jint8  # noqa: E402
from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    ragged_attention_lax, ragged_attention_pallas)
from paddle_tpu_torch.inference.llm import quant as tquant  # noqa: E402
from paddle_tpu_torch.inference.llm.kv_cache import CacheConfig  # noqa: E402
from paddle_tpu_torch.inference.llm.model import (  # noqa: E402
    TorchLM, params_from_jax)
from paddle_tpu_torch.kernels import int8 as tint8  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

H, D, PAGE = 2, 16, 8
TOL = 2e-5


def codes_np(codes):
    """Raw code bytes of a JAX or torch code array, as numpy."""
    if isinstance(codes, torch.Tensor):
        if codes.dtype == torch.float8_e4m3fn:
            return codes.view(torch.uint8).numpy()
        return codes.numpy()
    arr = np.asarray(codes)
    return arr.view(np.uint8) if arr.dtype.itemsize == 1 and \
        arr.dtype != np.int8 else arr


def codes_torch(codes):
    """A JAX code array as the port's pool tensor (int8 or float8)."""
    arr = np.asarray(codes)
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    return torch.from_numpy(arr.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


def _values(seed, shape):
    """Normal values with awkward rows: all-zero rows, a row of one
    huge and many tiny values, and rows whose absmax lands on 448."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 30.0], size=shape[:-1] + (1,)).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[3] = 1e-6
    flat[3, 5] = 1e4
    flat[4] = np.linspace(-448.0, 448.0, shape[-1], dtype=np.float32)
    flat[5] = np.float32(448.00003) * np.sign(flat[5] + 0.5)
    flat[6, :] = -1.0
    return x


@pytest.mark.parametrize("axis", [None, 0, -1])
@pytest.mark.parametrize("seed", range(3))
def test_quantize_absmax_bit_for_bit(axis, seed):
    x = _values(seed, (12, 8, 16))
    qj, sj = jint8.quantize_absmax(jnp.asarray(x), axis=axis)
    qt, st = tint8.quantize_absmax(torch.from_numpy(x), axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tint8.dequantize(qt, st).numpy(),
        np.asarray(jint8.dequantize(qj, sj)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("seed", range(3))
def test_quantize_kv_bit_for_bit(mode, seed):
    x = _values(seed, (5, PAGE, H, D))
    qj, sj = jax_quantize_kv(jnp.asarray(x), mode)
    qt, st = tquant.quantize_kv(torch.from_numpy(x), mode)
    assert qt.dtype == tquant.kv_pool_dtype(mode)
    assert tuple(st.shape) == x.shape[:-1] == tquant.kv_scale_shape(x.shape)
    np.testing.assert_array_equal(codes_np(qt), codes_np(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tquant.dequantize_kv(qt, st).numpy(),
        np.asarray(jax_dequantize_kv(qj, sj)))
    # zero rows: zero codes under the scale floor, not NaN
    assert (codes_np(qt).reshape(-1, D)[0] == 0).all()
    assert np.isfinite(tquant.dequantize_kv(qt, st).numpy()).all()


def test_fp8_range_edge_saturates_to_448():
    """The absmax maps onto 448 and may round a hair above it: both
    sides store 448 there, never NaN."""
    x = np.zeros((4, D), np.float32)
    x[0, 0] = 448.0
    x[1, :] = np.float32(448.00003)
    x[2, 3] = -3.0
    x[3, 7] = np.float32(1.0000001)
    qt, st = tquant.quantize_kv(torch.from_numpy(x), "fp8")
    qj, sj = jax_quantize_kv(jnp.asarray(x), "fp8")
    np.testing.assert_array_equal(codes_np(qt), codes_np(qj))
    deq = qt.to(torch.float32)
    assert torch.isfinite(deq).all()
    assert deq.abs().amax(dim=-1).tolist() == [448.0] * 4


def test_quantize_lm_weights_bit_for_bit():
    jm = JaxLM.tiny(num_layers=2)
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    jq = jax_quantize_lm_weights(jm.params, jm.spec)
    tq = tquant.quantize_lm_weights(params_from_jax(np_params, "cpu"),
                                    jm.spec)
    assert sorted(tq) == sorted(jq)
    for name, arr in jq.items():
        arr = np.asarray(arr)
        assert tq[name].numpy().dtype == arr.dtype, name
        np.testing.assert_array_equal(tq[name].numpy(), arr, err_msg=name)
    assert set(tquant.quantized_weight_names(jm.spec)) == {
        n[:-2] for n in tq if n.endswith("@q")}


def test_params_from_jax_keeps_int8_codes():
    jm = JaxLM.tiny(num_layers=2).quantize_weights()
    params = params_from_jax({k: np.asarray(v) for k, v in
                              jm.params.items()}, "cpu")
    for name, t in params.items():
        want = np.asarray(jm.params[name])
        assert t.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    assert params["l0.wqkv@q"].dtype == torch.int8
    assert params["l0.wqkv@s"].dtype == torch.float32
    # quantizing the carried-across float weights on the port's side
    # gives the same bytes
    fm = JaxLM.tiny(num_layers=2)
    tm = TorchLM(fm.spec, params_from_jax(
        {k: np.asarray(v) for k, v in fm.params.items()}, "cpu"),
        device="cpu").quantize_weights()
    assert tm.quantize_weights() is tm
    assert sorted(tm.params) == sorted(params)
    for name, t in params.items():
        assert torch.equal(tm.params[name], t), name


def _quant_mix(seed, mode, pages_per_seq=4, n_pool_pages=32, pad=5):
    """A ragged mix (decode, chunk, verify-shaped, idle rows and
    padding) over pools quantized by the JAX package's quantize_kv."""
    rng = np.random.default_rng(seed)
    q_lens = [1, 8, 4, 0, 1, 6]
    kv_lens = [int(rng.integers(ql, pages_per_seq * PAGE)) if ql else 0
               for ql in q_lens]
    kv_lens = [max(kv, ql) for kv, ql in zip(kv_lens, q_lens)]
    free = list(range(1, n_pool_pages))
    rng.shuffle(free)
    pt = np.array([[free.pop() for _ in range(pages_per_seq)]
                   for _ in q_lens], np.int32)
    q_starts = np.cumsum([0] + q_lens[:-1]).astype(np.int32)
    n = int(sum(q_lens)) + pad
    kf = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32)
    vf = rng.normal(size=(n_pool_pages, PAGE, H, D)).astype(np.float32) * 3
    kq, ks = jax_quantize_kv(jnp.asarray(kf), mode)
    vq, vs = jax_quantize_kv(jnp.asarray(vf), mode)
    q = rng.normal(size=(n, H, D)).astype(np.float32)
    rows = (pt, np.asarray(kv_lens, np.int32), q_starts,
            np.asarray(q_lens, np.int32))
    jax_args = ([jnp.asarray(q), kq, vq] + [jnp.asarray(a) for a in rows],
                dict(k_scale=ks, v_scale=vs))
    torch_args = ([torch.from_numpy(q), codes_torch(kq), codes_torch(vq)]
                  + [torch.from_numpy(a) for a in rows],
                  dict(k_scale=torch.from_numpy(np.array(ks)),
                       v_scale=torch.from_numpy(np.array(vs))))
    return jax_args, torch_args


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("seed", range(3))
def test_quantized_ref_matches_lax(mode, seed):
    (ja, jkw), (ta, tkw) = _quant_mix(seed, mode)
    want = np.asarray(ragged_attention_lax(*ja, **jkw))
    got = pa.ragged_attention_ref(*ta, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    n_used = int(ta[-1].sum())
    assert (got[n_used:] == 0.0).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_ref_matches_pallas_interpret(mode):
    (ja, jkw), (ta, tkw) = _quant_mix(11, mode)
    want = np.asarray(ragged_attention_pallas(*ja, interpret=True, **jkw))
    got = pa.ragged_attention(*ta, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_quantized_kernel_tier_refuses_cpu_tensors():
    _, (ta, tkw) = _quant_mix(2, "int8")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.ragged_attention(*ta, tier="kernel", **tkw)


def test_quant_config_validation():
    assert not tquant.QuantConfig().active
    assert tquant.QuantConfig(kv="fp8").kv_active
    assert tquant.QuantConfig(weights="int8").active
    with pytest.raises(ValueError):
        tquant.QuantConfig(kv="int4")
    with pytest.raises(ValueError):
        tquant.QuantConfig(weights="fp8")
    with pytest.raises(NotImplementedError, match="slice"):
        tquant.QuantConfig(coll="int8")
    for kw in (dict(weight_matmul="int4"), dict(scale_dtype="float64")):
        with pytest.raises(ValueError):
            tquant.QuantConfig(**kw)
    for sd in ("float32", "float16", "bfloat16"):
        assert tquant.QuantConfig(kv="int8", scale_dtype=sd).scale_dtype == sd
    assert tquant.QuantConfig(weights="int8",
                              weight_matmul="int8").weight_matmul == "int8"


@pytest.mark.parametrize("kv_quant", ["off", "int8", "fp8"])
def test_page_cost_matches_reference(kv_quant):
    geom = dict(num_layers=3, num_heads=4, head_dim=16, num_pages=40,
                page_size=8, max_slots=4, max_seq_len=256,
                kv_quant=kv_quant)
    t = CacheConfig(**geom)
    j = JaxCacheConfig(swap_pages=0, **geom)
    assert t.page_bytes() == j.page_bytes()
    assert t.pages_for_budget(1 << 20) == j.pages_for_budget(1 << 20)
    assert (t.dir_fanout, t.dir_entries, t.dir_capacity) == \
        (j.dir_fanout, j.dir_entries, j.dir_capacity)
