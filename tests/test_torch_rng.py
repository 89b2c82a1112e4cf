"""The port's threefry stream against ``jax.random`` and the JAX
package's ``core/random.py``, on the CPU.

Every comparison is bit for bit: ``split`` and ``bernoulli`` over
several shapes, probabilities and seeds; the threefry ``Generator``'s
key sequence, ``trace_key_scope`` (the step compiler's per-step keys)
and ``RNGStatesTracker`` (named streams) against the JAX package's, and
the recompute scopes (a replayed forward draws its first run's keys and
moves no generator).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paddle_tpu.core import random as jrng  # noqa: E402
from paddle_tpu_torch.core import random as trng  # noqa: E402
from paddle_tpu_torch.core import threefry  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


def _words(key) -> list:
    return [int(w) for w in np.asarray(key).astype(np.int64).reshape(-1)]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_is_jax_split(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = threefry.split(threefry.prng_key(seed), num)
    assert got.shape == (num, 2)
    assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 4, 5), (1, 1),
                                   (16, 1, 33)])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.999])
@pytest.mark.parametrize("seed", [1, 123])
def test_bernoulli_is_jax_bernoulli(shape, p, seed):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.bernoulli(key, p, shape))
    got = threefry.bernoulli(torch.tensor(_words(key)), p, shape)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


def test_bernoulli_flat_slice():
    """``start`` / ``count`` draw a flat slice of a larger shape (what the
    chip's comparison takes at the attention shape)."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.bernoulli(key, 0.7, (6, 50))).reshape(-1)
    got = threefry.bernoulli(threefry.prng_key(3), 0.7, (6, 50), 77, 120)
    assert np.array_equal(got.numpy(), want[77:197])


def test_uniform_and_gumbel_over_a_shape():
    key = jax.random.PRNGKey(11)
    tkey = threefry.prng_key(11)
    assert np.array_equal(threefry.uniform(tkey, (4, 9)).numpy(),
                          np.asarray(jax.random.uniform(key, (4, 9))))
    np.testing.assert_allclose(threefry.gumbel(tkey, (4, 9)).numpy(),
                               np.asarray(jax.random.gumbel(key, (4, 9))),
                               rtol=1e-6, atol=1e-6)


def test_generator_sequence_matches_jax():
    jg, tg = jrng.Generator(42), trng.Generator(42)
    for _ in range(5):
        assert threefry.key_words(tg.next_key()) == tuple(
            _words(jg.next_key()))
    assert tg.get_state().tolist() == _words(jg.get_state())
    state = tg.get_state()
    a = tg.next_key()
    tg.set_state(state)
    assert torch.equal(tg.next_key(), a)
    tg.manual_seed(3)
    jg.manual_seed(3)
    assert tg.next_key().tolist() == _words(jg.next_key())


def test_seed_reseeds_the_default_generator():
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice

    saved = tdevice._CURRENT[0]
    paddle.set_device("cpu")
    try:
        jpaddle.seed(9)
        paddle.seed(9)
        assert trng.next_key().tolist() == _words(jrng.next_key())
        assert trng.default_generator.get_state().tolist() == _words(
            jrng.get_rng_state())
    finally:
        tdevice._CURRENT[0] = saved


def test_trace_key_scope_and_tracker_match_jax():
    """Inside ``trace_key_scope`` keys split from the scope's key (also
    inside a tracker's stream, as the JAX ``Generator.next_key`` checks
    the trace stack first); a tracker's named stream otherwise splits
    its own generator."""
    step_key = jax.random.PRNGKey(5)
    jtr, ttr = jrng.RNGStatesTracker(), trng.RNGStatesTracker()
    jtr.add("model_parallel_rng", 17)
    ttr.add("model_parallel_rng", 17)
    with pytest.raises(ValueError):
        ttr.add("model_parallel_rng", 1)
    jrng.seed(2)
    trng.default_generator.manual_seed(2)
    got, want = [], []
    with jrng.trace_key_scope(step_key):
        want += [_words(jrng.next_key()) for _ in range(2)]
        with jtr.rng_state():
            want.append(_words(jrng.next_key()))
    with trng.trace_key_scope(torch.tensor(_words(step_key))):
        got += [trng.next_key().tolist() for _ in range(2)]
        with ttr.rng_state():
            got.append(trng.next_key().tolist())
    with jtr.rng_state():
        want.append(_words(jrng.next_key()))
    with ttr.rng_state():
        got.append(trng.next_key().tolist())
    want.append(_words(jrng.next_key()))
    got.append(trng.next_key().tolist())
    assert got == want
    with pytest.raises(ValueError):
        ttr.rng_state("nope")


def test_replay_keys_moves_no_generator():
    trng.default_generator.manual_seed(4)
    drawn: list = []
    with trng.record_keys(drawn):
        first = [trng.next_key() for _ in range(3)]
    state = trng.default_generator.get_state()
    with trng.replay_keys(drawn):
        again = [trng.next_key() for _ in range(3)]
        with pytest.raises(RuntimeError):
            trng.next_key()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(trng.default_generator.get_state(), state)
    assert len(drawn) == 3
