"""The port's GPT against the JAX package's, on the CPU.

The JAX model's parameters are carried across with
``gpt_params_from_jax``; the same seeded token ids go to both sides.

- ``GPTConfig.tiny()`` (head_dim 16: the plain attention route) in eval,
  as ``__graft_entry__.entry()`` builds and runs it: logits at
  rtol = atol = 1e-4 (float32 matmul sums in different orders, through
  two layers).
- A flash-eligible small config (vocab 256, hidden 128, 2 heads of 64,
  2 layers, MLP 256, S 256): logits at 1e-4; the plain loss and the
  chunked loss (4 chunks) at 1e-5 relative; every parameter's gradient
  against the JAX eager tape at rtol = atol = 1e-4 (float32; the port
  runs its flash route, JAX its reference attention).
- The port's fused and unfused forwards run the same operations in the
  same order: equal bits. The stacked-params ``fused_block_stack``
  against JAX's at 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.text import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.text import gpt as tgpt  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4
LOSS_RTOL = 1e-5

SMALL = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _jax_model(cfg, seed=0):
    paddle.seed(seed)
    return jgpt.GPTForCausalLM(cfg)


def _arrays(jm):
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _port(jm, **cfg):
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    return tgpt.gpt_params_from_jax(_arrays(jm), tm)


def test_tiny_forward_matches_graft_entry():
    import __graft_entry__

    fn, (param_arrays, ids) = __graft_entry__.entry()
    want = np.asarray(fn(param_arrays, ids))
    cfg = jgpt.GPTConfig.tiny()
    names = [n for n, _ in jgpt.GPTForCausalLM(cfg).named_parameters()]
    arrays = {n: np.asarray(a) for n, a in zip(names, param_arrays)}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(), device="cpu")
    tgpt.gpt_params_from_jax(arrays, tm).eval()
    with torch.no_grad():
        got = tm(torch.tensor(np.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def small():
    cfg = jgpt.GPTConfig(**SMALL)
    jm = _jax_model(cfg, seed=3)
    ids = np.random.RandomState(0).randint(0, 256, (2, 256)).astype(np.int32)
    return jm, ids


def test_small_logits_take_the_flash_route(small, monkeypatch):
    jm, ids = small
    tm = _port(jm, **SMALL)
    fwd_calls = []
    real = fa.flash_fwd_ref
    monkeypatch.setattr(fa, "flash_fwd_ref",
                        lambda *a: (fwd_calls.append(1), real(*a))[1])
    with torch.no_grad():
        got = tm(torch.tensor(ids))
    assert len(fwd_calls) == SMALL["num_hidden_layers"]
    want = np.asarray(jm(Tensor(jnp.asarray(ids)))._value)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunks", [1, 4])
def test_small_loss_and_grads_match_jax_tape(small, chunks):
    jm, ids = small
    labels = np.roll(ids, -1, axis=1)
    labels[:, -3:] = -100                       # ignored rows
    jm.config.loss_chunks = chunks
    try:
        for p in jm.parameters():
            p.grad = None
        jloss = jm.loss(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(labels)))
        jloss.backward()
        jgrads = {n: np.asarray(p.grad._value)
                  for n, p in jm.named_parameters()}
    finally:
        jm.config.loss_chunks = 1
    tm = _port(jm, **SMALL, loss_chunks=chunks)
    loss = tm.loss(torch.tensor(ids), torch.tensor(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss._value),
                               rtol=LOSS_RTOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_fused_and_unfused_forward_agree(small):
    jm, ids = small
    fused = _port(jm, **SMALL)
    unfused = _port(jm, **SMALL, fused_stack=False)
    with torch.no_grad():
        a = fused(torch.tensor(ids))
        b = unfused(torch.tensor(ids))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jm = _jax_model(jgpt.GPTConfig.tiny())
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
    arrays = _arrays(jm)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(), device="cpu")
    tgpt.gpt_params_from_jax(arrays, tm)
    got = dict(tm.named_parameters())
    assert list(got) == list(arrays)
    for name, arr in arrays.items():
        p = got[name]
        assert tuple(p.shape) == arr.shape, name
        assert str(p.dtype) == f"torch.{dtype}", name
        back = p.detach().float().numpy()
        np.testing.assert_array_equal(back, arr.astype(np.float32))
    arrays.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError):
        tgpt.gpt_params_from_jax(arrays, tm)


def test_bf16_arrays_keep_their_bits():
    arr = (np.random.RandomState(1).randn(256, 64) * 0.1).astype(
        ml_dtypes.bfloat16)
    jm = _jax_model(jgpt.GPTConfig.tiny())
    arrays = _arrays(jm)
    arrays["gpt.embeddings.word_embeddings.weight"] = arr
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(), device="cpu")
    tgpt.gpt_params_from_jax(arrays, tm)
    w = tm.gpt.embeddings.word_embeddings.weight
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.detach().view(torch.int16).numpy(),
                          arr.view(np.int16))


def test_unported_options_raise():
    base = dict(SMALL)
    with pytest.raises(NotImplementedError):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**base, use_mp=True), device="cpu")
    with pytest.raises(NotImplementedError):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**base, sp_mode="ring"),
                            device="cpu")
    # dropout in training and incremental decode are ported: tiny()
    # keeps dropout 0.1, which now drops in training and not in eval
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(), device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    assert tm(ids).shape == (1, 8, 256)
    tm.eval()
    assert torch.equal(tm(ids), tm(ids))
    assert tm.generate(ids, max_new_tokens=3).shape == (1, 11)


def test_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny())


@pytest.mark.parametrize("D,S", [(16, 64), (64, 128)])
def test_fused_block_stack_matches_jax(D, S):
    """The stacked-params entry (``[L, ...]`` arrays) on both sides: head
    dim 16 takes the reference attention, 64 the flash route on the
    port's side; float32 at 1e-4."""
    from paddle_tpu.kernels import fused_transformer as jft
    from paddle_tpu_torch.kernels import fused_transformer as tft

    L, H, nh = 2, 2 * D, 2
    rng = np.random.RandomState(D)
    shapes = [(H,), (H,), (H, 3 * H), (3 * H,), (H, H), (H,), (H,), (H,),
              (H, 4 * H), (4 * H,), (4 * H, H), (H,)]
    stacked = [(rng.randn(L, *s) * (0.1 if len(s) > 1 else 0.5)
                + (1.0 if i in (0, 6) else 0.0)).astype(np.float32)
               for i, s in enumerate(shapes)]
    x = rng.randn(2, S, H).astype(np.float32)
    want = jft.fused_block_stack(jnp.asarray(x),
                                 *map(jnp.asarray, stacked), num_heads=nh)
    got = tft.fused_block_stack(torch.tensor(x),
                                *map(torch.tensor, stacked), num_heads=nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    flat = [torch.tensor(p[i]) for i in range(L) for p in stacked]
    again = tft.fused_block_stack_flat(torch.tensor(x), *flat, num_layers=L,
                                       num_heads=nh)
    assert torch.equal(again, got)
    # the selective remat policies are ported: the forward is unchanged
    dots = tft.fused_block_stack(torch.tensor(x), *map(torch.tensor, stacked),
                                 num_heads=nh, remat="dots")
    assert torch.equal(dots, got)
