"""The port's LM step against the JAX reference.

``JaxLM.tiny``'s parameters are carried across with
``params_from_jax``; ``lm_ragged_step`` then runs on both sides over
several ragged steps with the pools threaded (the port updates its
pools in place, JAX returns new ones). Logits and pools agree at
rtol = atol = 1e-4: the two backends order their float32 matmul sums
differently. ``ragged_page_indices`` and the carry helpers are integer
bookkeeping and must be exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm import model as jmodel  # noqa: E402
from paddle_tpu.inference.llm.kv_cache import (  # noqa: E402
    ragged_page_indices as jax_indices)
from paddle_tpu.inference.llm.model import JaxLM  # noqa: E402
from paddle_tpu_torch.inference.llm import model as tmodel  # noqa: E402
from paddle_tpu_torch.inference.llm.kv_cache import (  # noqa: E402
    ragged_page_indices)
from paddle_tpu_torch.inference.llm.model import (  # noqa: E402
    TorchLM, init_lm_params, params_from_jax)
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4
PAGE = 8


@pytest.fixture(scope="module")
def models():
    jm = JaxLM.tiny(num_layers=2)
    np_params = {k: np.asarray(v) for k, v in jm.params.items()}
    tm = TorchLM(jm.spec, params_from_jax(np_params, "cpu"), device="cpu")
    return jm, tm


def _steps(max_slots=4, pages_per_seq=8):
    """A scripted run of ragged steps over four slots: (q_lens, pre-step
    resident lengths, padded width) per step — whole-prompt rows, a
    prefix-hit tail, decode rows, a later chunk, idle slots, and bucket
    padding."""
    return [([10, 7, 0, 0], [0, 0, 0, 0], 32),
            ([1, 1, 12, 0], [10, 7, 0, 0], 16),
            ([1, 1, 1, 5], [11, 8, 12, 16], 16),
            ([1, 0, 1, 1], [12, 9, 13, 21], 16),
            ([1, 1, 1, 1], [13, 9, 14, 22], 16)]


def _page_table(max_slots=4, pages_per_seq=8):
    pages = np.arange(1, 1 + max_slots * pages_per_seq, dtype=np.int32)
    return np.random.default_rng(0).permutation(pages).reshape(
        max_slots, pages_per_seq)


@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_step_matches_jax_over_threaded_steps(models, seed):
    jm, tm = models
    spec = jm.spec
    rng = np.random.default_rng(seed)
    pt = _page_table()
    n_pages = pt.size + 1
    shape = (spec.num_layers, n_pages, PAGE, spec.num_heads, spec.head_dim)
    kj = jnp.zeros(shape, jnp.float32)
    vj = jnp.zeros(shape, jnp.float32)
    kt = torch.zeros(shape)
    vt = torch.zeros(shape)
    for q_lens, pre, width in _steps():
        q_lens = np.asarray(q_lens, np.int32)
        kv_lens = np.asarray(pre, np.int32) + q_lens
        q_starts = np.cumsum([0] + list(q_lens[:-1])).astype(np.int32)
        tokens = rng.integers(0, spec.vocab, size=width).astype(np.int32)
        kj, vj, _, _, lj = jmodel.lm_ragged_step(
            jm.params, spec, jnp.asarray(tokens), jnp.asarray(q_starts),
            jnp.asarray(q_lens), jnp.asarray(kv_lens), kj, vj,
            jnp.asarray(pt), attn_tier="lax")
        lt = tmodel.lm_ragged_step(
            tm.params, spec, torch.from_numpy(tokens),
            torch.from_numpy(q_starts), torch.from_numpy(q_lens),
            torch.from_numpy(kv_lens), kt, vt, torch.from_numpy(pt),
            max_q_len=int(q_lens.max()))
        n = int(q_lens.sum())
        np.testing.assert_allclose(lt[:n].numpy(), np.asarray(lj)[:n],
                                   rtol=TOL, atol=TOL)
        # page 0 takes the padding tokens' K/V (duplicate scatter
        # indices keep an arbitrary one); only real pages are compared
        np.testing.assert_allclose(kt[:, 1:].numpy(), np.asarray(kj)[:, 1:],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(vt[:, 1:].numpy(), np.asarray(vj)[:, 1:],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("step", range(5))
def test_ragged_page_indices_exact(step):
    q_lens, pre, width = _steps()[step]
    q_lens = np.asarray(q_lens, np.int32)
    kv_lens = np.asarray(pre, np.int32) + q_lens
    q_starts = np.cumsum([0] + list(q_lens[:-1])).astype(np.int32)
    pt = _page_table()
    want = jax_indices(jnp.asarray(pt), jnp.asarray(q_starts),
                       jnp.asarray(q_lens), jnp.asarray(kv_lens), width, PAGE)
    got = ragged_page_indices(torch.from_numpy(pt), torch.from_numpy(q_starts),
                              torch.from_numpy(q_lens),
                              torch.from_numpy(kv_lens), width, PAGE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_layer_pieces_match(models):
    jm, tm = models
    x = np.random.default_rng(5).normal(
        size=(6, jm.spec.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    ln = jmodel._ln(jnp.asarray(x), jm.params["l0.ln1_g"] * 1.5,
                    jm.params["l0.ln1_b"] + 0.1)
    lnt = tmodel._ln(xt, tm.params["l0.ln1_g"] * 1.5,
                     tm.params["l0.ln1_b"] + 0.1)
    np.testing.assert_allclose(lnt.numpy(), np.asarray(ln), rtol=TOL,
                               atol=TOL)
    for a, b in zip(tmodel._qkv(tm.params, 1, xt),
                    jmodel._qkv(jm.params, 1, jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(tmodel._mlp(tm.params, 0, xt).numpy(),
                               np.asarray(jmodel._mlp(jm.params, 0,
                                                      jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


def test_carry_helpers_match():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 100, size=16).astype(np.int32)
    tok_src = np.array([-1, 2, -1, 0, 3, -1] + [-1] * 10, np.int32)
    carry = rng.integers(0, 100, size=4).astype(np.int32)
    want = jmodel.resolve_carry_tokens(jnp.asarray(tokens),
                                       jnp.asarray(tok_src),
                                       jnp.asarray(carry))
    got = tmodel.resolve_carry_tokens(torch.from_numpy(tokens),
                                      torch.from_numpy(tok_src),
                                      torch.from_numpy(carry))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q_starts = np.array([0, 5, 0, 9], np.int32)
    q_lens = np.array([5, 4, 0, 1], np.int32)
    want = jmodel.step_carry(jnp.asarray(tokens), jnp.asarray(q_starts),
                             jnp.asarray(q_lens), jnp.asarray(carry))
    got = tmodel.step_carry(torch.from_numpy(tokens),
                            torch.from_numpy(q_starts),
                            torch.from_numpy(q_lens),
                            torch.from_numpy(carry))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_params_layout_matches_jax(models):
    jm, _ = models
    params = init_lm_params(jm.spec, seed=0, device="cpu")
    assert sorted(params) == sorted(jm.params)
    for name, arr in jm.params.items():
        assert tuple(params[name].shape) == tuple(arr.shape), name
        assert params[name].dtype == torch.float32
    again = init_lm_params(jm.spec, seed=0, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchLM.tiny()


def _code_steps(a, b):
    """Per-element distance in code steps between two code arrays of
    raw bytes: int8 codes by value, e4m3 codes along the number line
    (sign-magnitude bytes)."""
    if a.dtype == np.int8:
        return np.abs(a.astype(np.int32) - b.astype(np.int32))
    a, b = a.astype(np.int32), b.astype(np.int32)
    same = (a >> 7) == (b >> 7)
    return np.where(same, np.abs((a & 0x7F) - (b & 0x7F)),
                    (a & 0x7F) + (b & 0x7F))


def _pool_bytes(pool):
    if isinstance(pool, torch.Tensor):
        return (pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn
                else pool).numpy()
    arr = np.asarray(pool)
    return arr if arr.dtype == np.int8 else arr.view(np.uint8)


@pytest.mark.parametrize("kv_mode", ["int8", "fp8"])
def test_quantized_ragged_step_matches_jax(kv_mode):
    """int8 weights and int8/fp8 KV pages over the threaded steps: the
    port's step (codes and scales written in place) against the JAX
    step (new pools returned) on the same carried-across int8 params.
    Logits agree at 1e-4; codes are equal except where the two
    backends' float32 K/V (matmul sums in different orders) straddle a
    rounding boundary, which moves a code by exactly one step — those
    are counted and must stay rare; scales agree at 1e-4."""
    from paddle_tpu.inference.llm.quant import QuantConfig as JaxQuantConfig
    from paddle_tpu_torch.inference.llm.quant import (QuantConfig,
                                                      kv_pool_dtype)

    jm = JaxLM.tiny(num_layers=2).quantize_weights()
    spec = jm.spec
    tparams = params_from_jax({k: np.asarray(v) for k, v in
                               jm.params.items()}, "cpu")
    jq = JaxQuantConfig(kv=kv_mode, weights="int8")
    tq = QuantConfig(kv=kv_mode, weights="int8")
    rng = np.random.default_rng(3)
    pt = _page_table()
    shape = (spec.num_layers, pt.size + 1, PAGE, spec.num_heads,
             spec.head_dim)
    from paddle_tpu.inference.llm.quant import kv_pool_dtype as jdtype
    kj = jnp.zeros(shape, jdtype(kv_mode))
    vj = jnp.zeros(shape, jdtype(kv_mode))
    ksj = jnp.zeros(shape[:-1], jnp.float32)
    vsj = jnp.zeros(shape[:-1], jnp.float32)
    kt = torch.zeros(shape, dtype=kv_pool_dtype(kv_mode))
    vt = torch.zeros(shape, dtype=kv_pool_dtype(kv_mode))
    kst = torch.zeros(shape[:-1])
    vst = torch.zeros(shape[:-1])
    flips = written = 0
    for q_lens, pre, width in _steps():
        q_lens = np.asarray(q_lens, np.int32)
        kv_lens = np.asarray(pre, np.int32) + q_lens
        q_starts = np.cumsum([0] + list(q_lens[:-1])).astype(np.int32)
        tokens = rng.integers(0, spec.vocab, size=width).astype(np.int32)
        kj, vj, ksj, vsj, lj = jmodel.lm_ragged_step(
            jm.params, spec, jnp.asarray(tokens), jnp.asarray(q_starts),
            jnp.asarray(q_lens), jnp.asarray(kv_lens), kj, vj,
            jnp.asarray(pt), attn_tier="lax", k_scale=ksj, v_scale=vsj,
            quant=jq, kv_split_pages=2)
        lt = tmodel.lm_ragged_step(
            tparams, spec, torch.from_numpy(tokens),
            torch.from_numpy(q_starts), torch.from_numpy(q_lens),
            torch.from_numpy(kv_lens), kt, vt, torch.from_numpy(pt),
            max_q_len=int(q_lens.max()), k_scale=kst, v_scale=vst,
            quant=tq, kv_split_pages=2)
        n = int(q_lens.sum())
        np.testing.assert_allclose(lt[:n].numpy(), np.asarray(lj)[:n],
                                   rtol=TOL, atol=TOL)
        # page 0 takes the padding tokens' K/V (duplicate scatter
        # indices keep an arbitrary one); only real pages are compared
        for t_pool, j_pool in ((kt, kj), (vt, vj)):
            steps = _code_steps(_pool_bytes(t_pool)[:, 1:],
                                _pool_bytes(j_pool)[:, 1:])
            assert steps.max() <= 1
            flips += int((steps == 1).sum())
        for t_s, j_s in ((kst, ksj), (vst, vsj)):
            np.testing.assert_allclose(t_s[:, 1:].numpy(),
                                       np.asarray(j_s)[:, 1:], rtol=TOL,
                                       atol=TOL)
        written += 2 * n * spec.num_layers * spec.num_heads * spec.head_dim
    assert flips <= written // 1000, (flips, written)
