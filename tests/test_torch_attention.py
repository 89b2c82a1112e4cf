"""The port's attention cores and dispatcher against the JAX package's.

``sdpa_reference`` and ``causal_sdpa_chunked`` run on the same seeded
numpy inputs on both sides: float32 at rtol = atol = 1e-5 (the same
float32 arithmetic, summed in different orders), bf16 chunked at 2e-2
(scores stored in bf16 on both sides, a step of 3.9e-3 relative, and
the two backends round their bf16 products at different points). The
dispatcher's route is checked per shape (flash for every eligible
shape, the JAX order otherwise) and its output against JAX's
``sdpa_array`` at 2e-4, the flash kernels' forward tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from paddle_tpu.kernels import attention as jattn  # noqa: E402
from paddle_tpu_torch.kernels import attention as attn  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5
BF16_TOL = 2e-2
DISPATCH_TOL = 2e-4


def _qkv(B, Sq, Sk, H, D, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, D) * 0.5).astype(np.float32)
            for S in (Sq, Sk, Sk)]


@pytest.mark.parametrize("Sq,Sk,causal", [(64, 64, False), (64, 64, True),
                                          (32, 96, True), (96, 32, True)])
def test_sdpa_reference_matches_jax(Sq, Sk, causal):
    arrays = _qkv(2, Sq, Sk, 3, 16, seed=Sq)
    out = attn.sdpa_reference(*map(torch.tensor, arrays), is_causal=causal)
    want = jattn.sdpa_reference(*map(jnp.asarray, arrays), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_sdpa_reference_masks_match_jax(kind):
    arrays = _qkv(1, 48, 48, 2, 16, seed=3)
    rng = np.random.RandomState(4)
    if kind == "bool":
        mask = rng.rand(1, 2, 48, 48) > 0.3
        mask[..., 0] = True
    else:
        mask = (rng.randn(1, 2, 48, 48) * 2).astype(np.float32)
    out = attn.sdpa_reference(*map(torch.tensor, arrays),
                              mask=torch.tensor(mask))
    want = jattn.sdpa_reference(*map(jnp.asarray, arrays),
                                mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("S,chunk", [(512, 256), (768, 256), (256, 64)])
def test_causal_chunked_matches_jax(S, chunk):
    arrays = _qkv(1, S, S, 2, 16, seed=S)
    out = attn.causal_sdpa_chunked(*map(torch.tensor, arrays), chunk=chunk)
    want = jattn.causal_sdpa_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    ref = attn.sdpa_reference(*map(torch.tensor, arrays), is_causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def test_causal_chunked_bf16_matches_jax():
    arrays = [a.astype(ml_dtypes.bfloat16)
              for a in _qkv(1, 512, 512, 2, 64, seed=8)]
    out = attn.causal_sdpa_chunked(*[torch.tensor(a.astype(np.float32),
                                                  dtype=torch.bfloat16)
                                     for a in arrays], chunk=256)
    want = jattn.causal_sdpa_chunked(*map(jnp.asarray, arrays), chunk=256)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("S", [128, 1024, 4096, 8192, 16384])
def test_chunk_rule_matches_jax(S):
    assert attn._causal_chunk_for(S) == jattn._causal_chunk_for(S)


# (Sq, Sk, D, causal, mask?) -> the route the dispatcher must take
ROUTES = [((256, 256, 64, True, False), "flash"),
          ((256, 256, 64, False, False), "flash"),
          ((128, 256, 128, True, False), "flash"),
          ((64, 64, 64, True, False), "flash"),
          ((512, 512, 16, True, False), "chunked"),
          ((256, 256, 16, True, False), "reference"),
          ((256, 256, 64, True, True), "reference"),
          ((192, 192, 64, True, False), "reference")]


@pytest.mark.parametrize("shape,route", ROUTES)
def test_dispatcher_routes_and_values(monkeypatch, shape, route):
    Sq, Sk, D, causal, with_mask = shape
    arrays = _qkv(1, Sq, Sk, 2, D, seed=Sq + D)
    mask = None
    if with_mask:
        mask = np.tril(np.ones((Sq, Sk), bool))[None, None]
    taken = []
    for name in ("flash_attention_bshd", "causal_sdpa_chunked",
                 "sdpa_reference"):
        real = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _r=real, _n=name, **k: (
            taken.append(_n), _r(*a, **k))[1])
    out = attn.sdpa_array(*map(torch.tensor, arrays), is_causal=causal,
                          mask=None if mask is None else torch.tensor(mask))
    want_name = {"flash": "flash_attention_bshd",
                 "chunked": "causal_sdpa_chunked",
                 "reference": "sdpa_reference"}[route]
    assert taken == [want_name]
    want = jattn.sdpa_array(*map(jnp.asarray, arrays), is_causal=causal,
                            mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=DISPATCH_TOL, atol=DISPATCH_TOL)


def test_dispatcher_refuses_dropout():
    """Attention dropout is ported: the dispatcher keeps a dropout call
    off the flash and chunked routes (the plain reference takes it, as
    in the JAX package) and draws the probabilities' mask from the key."""
    from paddle_tpu_torch.core import threefry

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    key = threefry.prng_key(9)
    got = attn.sdpa_array(q, k, v, is_causal=True, dropout_p=0.1, key=key)
    want = jattn.sdpa_array(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            is_causal=True, dropout_p=0.1,
                            key=jax.random.PRNGKey(9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DISPATCH_TOL, atol=DISPATCH_TOL)
    plain = attn.sdpa_reference(q, k, v, is_causal=True, dropout_p=0.1,
                                key=key)
    assert torch.equal(got, plain)
