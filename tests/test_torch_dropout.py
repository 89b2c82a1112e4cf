"""The port's dropout against the JAX package's, on the CPU.

Every function and layer (``dropout`` in both modes, with ``axis``, at
``p`` 0 and 1 and at inference, ``dropout2d``, ``dropout3d``,
``alpha_dropout``, ``Dropout``, ``Dropout2D``, ``Dropout3D``,
``AlphaDropout``) on the same numpy input from the same generator state:
outputs and input gradients bit-equal in float32, bfloat16 and float16,
and the generator states equal afterwards (no key drawn where nothing is
dropped). Attention-probability dropout in ``sdpa_reference`` and the
GPT model's dropout sites at float32 rounding (1e-5). The CPU runs the
dropout kernel's plain version (``kernels/dropout.py``), which the card
holds the kernel to bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
from paddle_tpu.core import random as jrng  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.kernels import attention as jattn  # noqa: E402
import paddle_tpu_torch.nn as tnn  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import random as trng  # noqa: E402
from paddle_tpu_torch.core import threefry  # noqa: E402
from paddle_tpu_torch.kernels import attention as tattn  # noqa: E402
from paddle_tpu_torch.kernels import dropout as tdrop  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
ATTN_TOL = 1e-5


def _seed(n):
    jrng.seed(n)
    trng.default_generator.manual_seed(n)


def _states_equal():
    return trng.default_generator.get_state().tolist() == [
        int(w) for w in np.asarray(jrng.get_rng_state()).astype(np.int64)]


def _pair(x, dtype):
    jdt, tdt = DTYPES[dtype]
    jx = Tensor(jnp.asarray(x).astype(jdt), stop_gradient=False)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    return jx, tx


def _bits_equal(jy, ty):
    a = np.asarray(jy._value.astype(jnp.float32))
    b = ty.detach().float().numpy()
    return np.array_equal(a, b) and np.array_equal(np.signbit(a),
                                                   np.signbit(b))


def _check(jfn, tfn, shape, dtype, seed=3):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _seed(seed)
    jy, ty = jfn(jx), tfn(tx)
    assert _bits_equal(jy, ty)
    assert _states_equal()
    if not ty.requires_grad:            # p == 1: zeros cut from the graph
        assert jy.stop_gradient
        return
    g = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    jdt, tdt = DTYPES[dtype]
    (jy * Tensor(jnp.asarray(g).astype(jdt))).sum().backward()
    (ty * torch.tensor(g).to(tdt)).sum().backward()
    if jx.grad is None:
        assert tx.grad is None or not tx.grad.any()
    else:
        assert _bits_equal(jx.grad, tx.grad)


CASES = {
    "p0.1": dict(p=0.1),
    "p0.5": dict(p=0.5),
    "axis1": dict(p=0.3, axis=1),
    "axis01": dict(p=0.4, axis=[0, 1]),
    "downscale": dict(p=0.3, mode="downscale_in_infer"),
    "downscale_infer": dict(p=0.3, mode="downscale_in_infer",
                            training=False),
    "infer": dict(p=0.3, training=False),
    "p0": dict(p=0.0),
    "p1": dict(p=1.0),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_dropout_matches_jax(case, dtype):
    kw = CASES[case]
    _check(lambda x: JF.dropout(x, **kw), lambda x: TF.dropout(x, **kw),
           (4, 6, 5), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn,shape", [("dropout2d", (2, 3, 4, 5)),
                                      ("dropout3d", (2, 3, 2, 4, 3)),
                                      ("alpha_dropout", (3, 7, 5))])
def test_dropout_nd_and_alpha_match_jax(fn, shape, dtype):
    _check(lambda x: getattr(JF, fn)(x, 0.3),
           lambda x: getattr(TF, fn)(x, 0.3), shape, dtype)


@pytest.mark.parametrize("layer,shape,kw", [
    ("Dropout", (4, 9), dict(p=0.2)),
    ("Dropout", (4, 9, 3), dict(p=0.5, axis=2)),
    ("Dropout2D", (2, 3, 4, 4), dict(p=0.5)),
    ("Dropout3D", (2, 3, 2, 2, 2), dict(p=0.5)),
    ("AlphaDropout", (5, 8), dict(p=0.25))])
def test_dropout_layers_match_jax(layer, shape, kw):
    jl, tl = getattr(jnn, layer)(**kw), getattr(tnn, layer)(**kw)
    _check(jl, tl, shape, "float32")
    jl.eval()
    tl.eval()
    _check(jl, tl, shape, "float32", seed=8)


def test_dropout_kernel_wrapper_refuses_cpu_and_odd_p():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        tdrop.dropout_cuda(x, threefry.prng_key(0), 0.5)
    assert tdrop.mask_geometry((2, 3, 4), (2, 1, 4)) == ((2, 3, 4),
                                                        (4, 0, 1))
    assert tdrop.mask_geometry((2, 3), None) is None
    with pytest.raises(ValueError):
        tdrop.mask_geometry((2, 3), (3, 3))


def test_dropout_ref_flat_slice_is_the_whole_draw():
    """The plain version over a flat slice (``start``) gives that slice
    of the whole tensor's dropout."""
    x = torch.randn(5, 40)
    key = threefry.prng_key(12)
    whole = tdrop.dropout_ref(x, key, 0.1).reshape(-1)
    part = tdrop.dropout_ref(x.reshape(-1)[33:150], key, 0.1, start=33)
    assert torch.equal(part, whole[33:150])


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_reference_dropout_matches_jax(causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    key = jax.random.PRNGKey(21)
    want = jattn.sdpa_reference(*map(jnp.asarray, (q, k, v)),
                                is_causal=causal, dropout_p=0.2, key=key)
    got = tattn.sdpa_reference(*map(torch.tensor, (q, k, v)),
                               is_causal=causal, dropout_p=0.2,
                               key=threefry.prng_key(21))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    # the attention probabilities' dropout alone, bit for bit
    p = rng.random((2, 2, 16, 16)).astype(np.float32)
    keep = np.asarray(jax.random.bernoulli(key, 0.8, p.shape))
    dropped = tdrop.dropout(torch.tensor(p), threefry.prng_key(21), 0.2)
    want_p = np.where(keep, p / np.float32(0.8), 0.0)
    assert np.array_equal(dropped.numpy(), want_p)


def test_sdpa_functional_draws_one_key_only_in_training():
    """``F.scaled_dot_product_attention`` draws a key (and drops) only in
    training with ``dropout_p > 0``, as the JAX op."""
    rng = np.random.default_rng(6)
    arrs = [rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
            for _ in range(3)]
    for training in (True, False):
        _seed(30)
        want = JF.scaled_dot_product_attention(
            *(Tensor(jnp.asarray(a)) for a in arrs), dropout_p=0.3,
            is_causal=True, training=training)
        got = TF.scaled_dot_product_attention(
            *map(torch.tensor, arrs), dropout_p=0.3, is_causal=True,
            training=training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)
        assert _states_equal()


def test_gpt_dropout_sites_match_jax():
    """A tiny GPT in training with dropout 0.1 / 0.1 (unfused, as
    ``_can_fuse`` says): the loss and every gradient at float32
    rounding from one generator state, the generator states equal after;
    in eval the dropout-free fused stack."""
    from paddle_tpu.text import gpt as jgpt
    from paddle_tpu_torch.text import gpt as tgpt

    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=32)
    jpaddle.seed(1)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    tm = tgpt.gpt_params_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu"))
    ids = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(np.int32)
    assert not tm.gpt._can_fuse() and not jm.gpt._can_fuse()
    _seed(17)
    jl = jm.loss(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(ids)))
    tl = tm.loss(torch.tensor(ids).long(), torch.tensor(ids).long())
    assert _states_equal()
    np.testing.assert_allclose(tl.item(), float(jl._value), rtol=ATTN_TOL)
    jl.backward()
    tl.backward()
    jp = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jp[name].grad._value),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    jm.eval()
    tm.eval()
    assert tm.gpt._can_fuse()
    with torch.no_grad():
        got = tm(torch.tensor(ids).long()).numpy()
    want = np.asarray(jm(Tensor(jnp.asarray(ids)))._value)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
