"""The port's threefry RNG and sampler against ``jax.random``.

Sampled tokens of the two engines are equal only if the random bits
are: ``prng_key``, ``fold_in``, the raw bits and the uniforms must equal
the installed JAX's bit for bit. The Gumbel noise goes through each
backend's own float32 ``log`` (close, not bit-equal), and
``categorical`` draws and ``_sample_traced`` tokens must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.inference.llm.engine import (  # noqa: E402
    _sample_traced as jax_sample, resolve_sampling as jax_resolve,
    SamplingParams as JaxSP)
from paddle_tpu_torch.inference.llm import threefry as tf  # noqa: E402
from paddle_tpu_torch.inference.llm.engine import (  # noqa: E402
    SamplingParams, _sample_traced, resolve_sampling)
from _torch_threads import one_thread  # noqa: E402,F401

TINY = float(np.finfo(np.float32).tiny)


def _seeds_positions(seed, n=64):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 1 << 31, size=n).astype(np.int32)
    seeds[:4] = [0, 1, 2 ** 31 - 1, 12345]
    pos = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    pos[:4] = [0, 1, 1023, 7]
    return seeds, pos


def _jax_keys(seeds, pos):
    return jax.vmap(lambda s, n: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    n))(seeds, pos)


def _torch_keys(seeds, pos):
    return tf.fold_in(tf.prng_key(torch.from_numpy(seeds)),
                      torch.from_numpy(pos))


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_prng_key_and_fold_in_bitwise(seed):
    seeds, pos = _seeds_positions(seed)
    want = jax.vmap(jax.random.PRNGKey)(seeds)
    got = tf.prng_key(torch.from_numpy(seeds))
    np.testing.assert_array_equal(got.numpy(), _u32(want))
    np.testing.assert_array_equal(_torch_keys(seeds, pos).numpy(),
                                  _u32(_jax_keys(seeds, pos)))


def test_threefry2x32_known_answer():
    # the Threefry-2x32 (20 rounds) test vector JAX's own tests pin
    o0, o1 = tf.threefry2x32(torch.tensor(0x13198A2E), torch.tensor(0x03707344),
                             torch.tensor(0x243F6A88), torch.tensor(0x85A308D3))
    assert (int(o0), int(o1)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("n", [1, 127, 1000])
def test_random_bits_and_uniform_bitwise(n):
    seeds, pos = _seeds_positions(n)
    jk = _jax_keys(seeds, pos)
    tk = _torch_keys(seeds, pos)
    np.testing.assert_array_equal(
        tf.random_bits(tk, n).numpy(),
        _u32(jax.vmap(lambda k: jax.random.bits(k, (n,)))(jk)))
    np.testing.assert_array_equal(
        tf.uniform(tk, n, minval=TINY).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=TINY))(jk)))


def test_gumbel_matches_within_the_backends_log():
    """The uniforms are bit-equal; ``-log(-log(u))`` then goes through
    each backend's float32 ``log`` (XLA's CPU log is its own polynomial
    approximation), and near u -> 1 the outer log turns the inner
    log's last-ulp difference into ~1e-4 absolute. The draws that
    matter are the categorical ones below, which must be equal."""
    seeds, pos = _seeds_positions(9)
    jk = _jax_keys(seeds, pos)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (500,)))(jk))
    got = tf.gumbel(_torch_keys(seeds, pos), 500).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", range(3))
def test_categorical_draws_equal(seed):
    seeds, pos = _seeds_positions(seed, n=256)
    logits = np.random.default_rng(seed).normal(
        size=(256, 300)).astype(np.float32) * 3
    want = jax.vmap(jax.random.categorical)(_jax_keys(seeds, pos),
                                            jnp.asarray(logits))
    got = tf.categorical(_torch_keys(seeds, pos), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


KNOBS = {"greedy": (0.0, 0, 1.0), "temperature": (0.7, 0, 1.0),
         "top_k": (1.0, 5, 1.0), "top_p": (1.3, 0, 0.8),
         "all": (0.8, 50, 0.9), "top_k_1": (0.9, 1, 1.0)}


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_sample_traced_tokens_equal(knobs):
    temp, top_k, top_p = KNOBS[knobs]
    B, V = 48, 257
    rng = np.random.default_rng(len(knobs))
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    seeds, pos = _seeds_positions(len(knobs), n=B)
    cols = [np.full(B, temp, np.float32), np.full(B, top_k, np.int32),
            np.full(B, top_p, np.float32)]
    want = jax_sample(jnp.asarray(logits), jnp.asarray(seeds),
                      jnp.asarray(pos), *[jnp.asarray(c) for c in cols])
    got = _sample_traced(torch.from_numpy(logits), torch.from_numpy(seeds),
                         torch.from_numpy(pos),
                         *[torch.from_numpy(c) for c in cols])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_traced_mixed_rows_equal():
    """Greedy and sampled rows with different knobs in one call, as the
    engine packs them."""
    B, V = 6, 200
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(B, V)).astype(np.float32)
    seeds, pos = _seeds_positions(11, n=B)
    temp = np.array([0.0, 0.8, 1.0, 0.0, 0.5, 2.0], np.float32)
    top_k = np.array([0, 50, 0, 3, 10, -1], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 1.0, 0.95], np.float32)
    want = jax_sample(*[jnp.asarray(a) for a in
                        (logits, seeds, pos, temp, top_k, top_p)])
    got = _sample_traced(*[torch.from_numpy(a) for a in
                           (logits, seeds, pos, temp, top_k, top_p)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_sampling_draws_the_same_seeds():
    a, b = np.random.default_rng(90210), np.random.default_rng(90210)
    for sp, jsp in [(None, None), (SamplingParams(temperature=0.5),
                                   JaxSP(temperature=0.5)),
                    (SamplingParams(seed=3), JaxSP(seed=3))]:
        got, want = resolve_sampling(sp, a), jax_resolve(jsp, b)
        assert (got.temperature, got.top_k, got.top_p, got.seed) == \
            (want.temperature, want.top_k, want.top_p, want.seed)
