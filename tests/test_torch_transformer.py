"""The port's Transformer against the JAX package's, on the CPU.

``chip_smoke.make_nmt`` (the smoke's translation model, written against
the Paddle API of either package) at 2 + 2 layers, ``d_model`` 64, 4
heads, feed-forward 128 and a 97-token vocabulary, the JAX model's
weights carried over by name:

- eval logits within 1e-5 and every parameter's gradient of the
  label-smoothed loss within 1e-4 (relative), under
  ``generate_square_subsequent_mask``;
- training-mode logits from one threefry seed within 1e-5: the hidden
  and attention-probability dropout masks are the JAX package's bits;
- greedy incremental decoding through ``MultiHeadAttention.Cache``:
  the JAX package's tokens and per-step logits (1e-5), and the whole
  decoder over the same tokens under the causal mask gives the same
  logits;
- ``gen_cache(type=StaticCache)``'s quirk (the q and k projections of
  the key stored as k and v), equal to the JAX package's tensors;
- the ``[B, 1, 1, S]`` additive padding mask: padded sources match the
  JAX package's, and the port's own unpadded run at the real positions
  (1e-5); ``generate_square_subsequent_mask`` equals the JAX one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.core.random as jrandom  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import random as trandom  # noqa: E402
from paddle_tpu_torch.nn import layer_state_from_jax  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

CFG = dict(vocab=97, d_model=64, nhead=4, layers=2, ff=128, dropout=0.1)
B, S, T = 3, 5, 4
TOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    return np.asarray(x.numpy())


@pytest.fixture
def models():
    jp.seed(3)
    jm = cs.make_nmt(jp, **CFG)
    tm = cs.make_nmt(tp, **CFG)
    layer_state_from_jax({k: _np(v) for k, v in jm.state_dict().items()},
                         tm)
    return jm, tm


def _batch(p, seed=1, src_len=S):
    return cs.nmt_batch(p, CFG["vocab"], B, src_len, T, seed)


def test_eval_logits_and_gradients_match_jax(models):
    jm, tm = models
    jm.eval()
    tm.eval()
    outs, grads = [], []
    for p, m in ((jp, jm), (tp, tm)):
        src, tin, tout = _batch(p)
        mask = p.nn.Transformer.generate_square_subsequent_mask(T)
        outs.append(_np(m(src, tin, None, mask)))
        cs.nmt_loss(p, m, src, tin, tout, CFG["vocab"],
                    tgt_mask=mask).backward()
        grads.append({n: _np(q.grad) for n, q in m.named_parameters()})
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)
    assert set(grads[1]) == set(grads[0])
    for n, g in grads[0].items():
        np.testing.assert_allclose(grads[1][n], g, rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=n)


def test_training_dropout_masks_are_the_jax_bits(models):
    jm, tm = models
    outs = []
    for p, m, seed in ((jp, jm, jrandom.seed),
                       (tp, tm, trandom.default_generator.manual_seed)):
        m.train()
        src, tin, _ = _batch(p)
        mask = p.nn.Transformer.generate_square_subsequent_mask(T)
        seed(5)
        outs.append(_np(m(src, tin, None, mask)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)
    tm.eval()
    assert not np.allclose(_np(tm(*_batch(tp)[:2])), outs[1], atol=1e-3)


def test_incremental_decode_matches_jax_and_the_full_decoder(models):
    jm, tm = models
    got = []
    for p, m in ((jp, jm), (tp, tm)):
        m.eval()
        src, _, _ = _batch(p, seed=2)
        toks, logits = cs.nmt_decode(p, m, src, T)
        got.append((_np(toks), _np(logits)))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=TOL, atol=TOL)
    src, _, _ = _batch(tp, seed=2)
    toks = tp.to_tensor(got[1][0])
    inp = tp.concat([tp.full([B, 1], cs.NMT_BOS, dtype="int64"),
                     toks[:, :-1]], axis=1)
    full = tm(src, inp, None,
              tp.nn.Transformer.generate_square_subsequent_mask(T))
    np.testing.assert_allclose(_np(full.transpose(0, 1)), got[1][1],
                               rtol=TOL, atol=TOL)
    forced, flogits = cs.nmt_decode(tp, tm, src, T, forced=toks)
    np.testing.assert_array_equal(_np(forced), got[1][0])


def test_static_cache_quirk_matches_jax(models):
    """The JAX package's ``gen_cache(type=StaticCache)`` keeps the q and
    k projections of the key (``transformer.py:56-57``); the port keeps
    the quirk (ROADMAP queue C)."""
    jm, tm = models
    x = np.random.RandomState(4).randn(B, S, CFG["d_model"]).astype(
        "float32")
    caches = []
    for p, m in ((jp, jm), (tp, tm)):
        attn = m.transformer.decoder.layers[0].cross_attn
        c = attn.gen_cache(p.to_tensor(x), type=attn.StaticCache)
        assert type(c).__name__ == "StaticCache"
        caches.append((_np(c.k), _np(c.v)))
        heads = (B, S, CFG["nhead"], CFG["d_model"] // CFG["nhead"])
        np.testing.assert_allclose(
            caches[-1][0], _np(attn.q_proj(p.to_tensor(x))).reshape(heads),
            rtol=TOL, atol=TOL)
        empty = attn.gen_cache(p.to_tensor(x))
        assert type(empty).__name__ == "Cache" and empty.k.shape[1] == 0
    for g, w in zip(caches[1], caches[0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_padding_mask_and_subsequent_mask(models):
    jm, tm = models
    np.testing.assert_array_equal(
        _np(tp.nn.Transformer.generate_square_subsequent_mask(5)),
        _np(jp.nn.Transformer.generate_square_subsequent_mask(5)))
    assert tp.nn.Transformer.generate_square_subsequent_mask(
        5).dtype == torch.float32
    real, pad_to = 3, S
    outs = []
    for p, m in ((jp, jm), (tp, tm)):
        m.eval()
        src, tin, _ = _batch(p, seed=6, src_len=real)
        src_np = _np(src)
        padded = np.concatenate([src_np, np.full((B, pad_to - real),
                                                 cs.NMT_PAD)], 1)
        mask = np.where(padded == cs.NMT_PAD, -1e9, 0.0).astype(
            "float32").reshape(B, 1, 1, pad_to)
        causal = p.nn.Transformer.generate_square_subsequent_mask(T)
        outs.append((_np(m(p.to_tensor(padded), tin, p.to_tensor(mask),
                           causal)),
                     _np(m.encode(p.to_tensor(padded), p.to_tensor(mask))),
                     _np(m(src, tin, None, causal)),
                     _np(m.encode(src))))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    logits_p, mem_p, logits_u, mem_u = outs[1]
    np.testing.assert_allclose(mem_p[:, :real], mem_u, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits_p, logits_u, rtol=TOL, atol=TOL)


def test_multi_head_attention_cache_steps_match_jax():
    """``MultiHeadAttention`` alone (other kdim and vdim) over a
    grown ``Cache``, against the JAX layer with the same weights."""
    jl = jp.nn.MultiHeadAttention(16, 2, kdim=12, vdim=10)
    tl = tp.nn.MultiHeadAttention(16, 2, kdim=12, vdim=10)
    layer_state_from_jax({k: _np(v) for k, v in jl.state_dict().items()},
                         tl)
    r = np.random.RandomState(8)
    q, k, v = (r.randn(2, 3, n).astype("float32") for n in (16, 12, 10))
    outs = []
    for p, layer in ((jp, jl), (tp, tl)):
        layer.eval()
        cache = layer.gen_cache(p.to_tensor(q))
        out, cache = layer(p.to_tensor(q), p.to_tensor(k), p.to_tensor(v),
                           None, cache)
        out2, cache = layer(p.to_tensor(q), p.to_tensor(k), p.to_tensor(v),
                            None, cache)
        outs.append((_np(out), _np(out2), _np(cache.k)))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
