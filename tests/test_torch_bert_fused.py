"""The port's ``text.bert`` and ``incubate.nn`` against the JAX
package's, on the CPU.

- BERT at ``BertConfig.tiny()`` (the JAX weights carried over by name):
  the classifier's logits, the sequence output and the pooled output
  without a mask, with a boolean keep-mask and with an additive float
  mask (``[B, 1, 1, S]``, padded rows), at rtol = atol = 1e-5; one AdamW
  step (decay off for biases and LayerNorms by name) in eval and in
  train with the dropouts at 0: the loss at 1e-5, every parameter after
  the step at 1e-4 (but the attention's key biases, whose gradient is 0
  up to rounding in both packages: Adam scales that noise to +-lr).
- Every ``incubate.nn`` functional and layer at embed 64 and 4 heads on
  seeded inputs: ``fused_linear`` (both weight layouts),
  ``fused_bias_dropout_residual_layer_norm``,
  ``fused_multi_head_attention`` in both ``qkv_weight`` layouts, pre-
  and post-LN, with and without a mask, ``fused_feedforward`` (pre /
  post, relu / gelu), ``fused_multi_transformer`` at 2 layers; the
  layers with the JAX weights, ``FusedTransformerEncoderLayer`` also
  backward (every gradient); the JAX raises. float32 at 1e-5. In
  training with dropout the threefry keys are the JAX package's: the
  same seed gives the same masks, so the outputs agree there too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.incubate.nn as jinn  # noqa: E402
import paddle_tpu.incubate.nn.functional as JFF  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
from paddle_tpu.core import random as jrandom  # noqa: E402
from paddle_tpu.text import bert as jbert  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.incubate.nn as tinn  # noqa: E402
import paddle_tpu_torch.incubate.nn.functional as TFF  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import random as trandom  # noqa: E402
from paddle_tpu_torch.nn import layer_state_from_jax  # noqa: E402
from paddle_tpu_torch.text import bert as tbert  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, E, H = 2, 16, 64, 4


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(t):
    return np.asarray(t.numpy()) if not isinstance(t, torch.Tensor) \
        else t.detach().numpy()


def _carry(jm, tm):
    layer_state_from_jax({n: _np(p) for n, p in jm.state_dict().items()}, tm)
    return tm


def _seed(n):
    jrandom.seed(n)
    trandom.default_generator.manual_seed(n)


# ----------------------------------------------------------------- BERT ---

def _berts(**over):
    cfg = dict(vars(tbert.BertConfig.tiny()), **over)
    jpaddle.seed(1)
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**cfg))
    tm = tbert.BertForSequenceClassification(tbert.BertConfig(**cfg))
    return jm, _carry(jm, tm)


def _batch(seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, S)).astype(np.int64)
    types = (np.arange(S)[None, :] >= S // 2).astype(np.int64).repeat(B, 0)
    keep = np.ones((B, 1, 1, S), bool)
    keep[1, ..., 11:] = False
    labels = np.array([0, 1], np.int64)
    return ids, types, keep, labels


def _masks(keep):
    add = np.where(keep, 0.0, -1e4).astype(np.float32)
    return {"none": (None, None),
            "bool": (torch.tensor(keep), jpaddle.to_tensor(keep)),
            "additive": (torch.tensor(add), jpaddle.to_tensor(add))}


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_bert_outputs_match_jax(mask):
    jm, tm = _berts()
    jm.eval()
    tm.eval()
    ids, types, keep, _ = _batch()
    tmask, jmask = _masks(keep)[mask]
    jargs = (jpaddle.to_tensor(ids), jpaddle.to_tensor(types), jmask)
    targs = (torch.tensor(ids), torch.tensor(types), tmask)
    np.testing.assert_allclose(_np(tm(*targs)), _np(jm(*jargs)), **TOL)
    for a, b in zip(tm.bert(*targs), jm.bert(*jargs)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_bert_config_matches_jax():
    assert tbert.BertConfig.base() == tbert.BertConfig()
    assert vars(tbert.BertConfig.base()) == vars(jbert.BertConfig.base())
    assert vars(tbert.BertConfig.tiny()) == vars(jbert.BertConfig.tiny())
    jm, tm = _berts()
    # exact erf GELU, as the JAX layer's "gelu"
    assert tm.bert.encoder.layers[0]._act == "gelu"
    assert set(tm.state_dict()) == set(jm.state_dict())


def _decay(name):
    return not (name.endswith("bias") or "norm" in name
                or "layer_norm" in name)


@pytest.mark.parametrize("train", [False, True])
def test_bert_adamw_step_matches_jax(train):
    jm, tm = _berts(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    for m in (jm, tm):
        m.train() if train else m.eval()
    ids, types, keep, labels = _batch(3)
    jopt = jpaddle.optimizer.AdamW(1e-3, parameters=jm.parameters(),
                                   apply_decay_param_fun=_decay)
    topt = tpaddle.optimizer.AdamW(1e-3, parameters=list(
        tm.named_parameters()), apply_decay_param_fun=_decay)
    # the JAX decay function reads each parameter's name: the structured
    # one, as the port's pairs give it
    for n, p in jm.named_parameters():
        p.name = n
    jloss = JF.cross_entropy(jm(jpaddle.to_tensor(ids),
                                jpaddle.to_tensor(types),
                                jpaddle.to_tensor(keep)),
                             jpaddle.to_tensor(labels))
    jloss.backward()
    jopt.step()
    tloss = TF.cross_entropy(tm(torch.tensor(ids), torch.tensor(types),
                                torch.tensor(keep)), torch.tensor(labels))
    tloss.backward()
    topt.step()
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        if n.endswith("k_proj.bias"):
            # a key bias shifts every score of a row alike: its gradient
            # is 0 but for rounding, which Adam scales up to +-lr
            assert np.abs(_np(p.grad)).max() < 1e-6
            assert np.abs(_np(jp[n].grad)).max() < 1e-6
            continue
        np.testing.assert_allclose(_np(p), _np(jp[n]), **STEP_TOL,
                                   err_msg=n)


# ---------------------------------------------------------- functionals ---

def _arr(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(*arrays):
    return ([torch.tensor(a) if a is not None else None for a in arrays],
            [jpaddle.to_tensor(a) if a is not None else None for a in arrays])


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_jax(transpose):
    x, w, b = _arr((B, S, E), 1, 1.0), _arr((32, E) if transpose
                                            else (E, 32), 2), _arr((32,), 3)
    (tx, tw, tb), (jx, jw, jb) = _pair(x, w, b)
    np.testing.assert_allclose(
        _np(TFF.fused_linear(tx, tw, tb, transpose)),
        _np(JFF.fused_linear(jx, jw, jb, transpose)), **TOL)
    assert TFF.fused_matmul_bias is TFF.fused_linear


@pytest.mark.parametrize("training", [False, True])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(training):
    arrays = (_arr((B, S, E), 4, 1.0), _arr((B, S, E), 5, 1.0),
              _arr((E,), 6), 1.0 + _arr((E,), 7), _arr((E,), 8))
    t, j = _pair(*arrays)
    _seed(9)
    got = TFF.fused_bias_dropout_residual_layer_norm(
        *t, dropout_rate=0.3, training=training)
    want = JFF.fused_bias_dropout_residual_layer_norm(
        *j, dropout_rate=0.3, training=training)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _mha_weights(layout, seed=10):
    D = E // H
    qkv = (_arr((3, H, D, E), seed) if layout == "4d"
           else _arr((E, 3 * E), seed))
    return (qkv, _arr((E, E), seed + 1), 1.0 + _arr((E,), seed + 2),
            _arr((E,), seed + 3), 1.0 + _arr((E,), seed + 4),
            _arr((E,), seed + 5), _arr((3 * E,), seed + 6),
            _arr((E,), seed + 7))


@pytest.mark.parametrize("layout", ["4d", "2d"])
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_multi_head_attention_matches_jax(layout, pre_ln, masked):
    x = _arr((B, S, E), 20, 1.0)
    qkv, lw, pls, plb, ls, lb, qb, lbias = _mha_weights(layout)
    keep = _batch()[2] if masked else None
    t, j = _pair(x, qkv, lw, pls, plb, ls, lb, qb, lbias, keep)
    outs = []
    for fn, (x_, qkv_, lw_, pls_, plb_, ls_, lb_, qb_, lbias_, keep_) in (
            (TFF.fused_multi_head_attention, t),
            (JFF.fused_multi_head_attention, j)):
        outs.append(fn(x_, qkv_, lw_, pre_layer_norm=pre_ln,
                       pre_ln_scale=pls_, pre_ln_bias=plb_, ln_scale=ls_,
                       ln_bias=lb_, qkv_bias=qb_, linear_bias=lbias_,
                       attn_mask=keep_, training=False,
                       num_heads=None if layout == "4d" else H))
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), **TOL)


def test_fused_multi_head_attention_raises_as_jax():
    qkv = _arr((E, 3 * E), 1)
    for fn, to in ((TFF.fused_multi_head_attention, torch.tensor),
                   (JFF.fused_multi_head_attention, jpaddle.to_tensor)):
        x, w, lw = to(_arr((B, S, E), 2)), to(qkv), to(_arr((E, E), 3))
        with pytest.raises(ValueError, match="num_heads"):
            fn(x, w, lw)
        with pytest.raises(NotImplementedError, match="cache_kv"):
            fn(x, w, lw, cache_kv=x, num_heads=H)


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("training", [False, True])
def test_fused_feedforward_matches_jax(pre_ln, act, training):
    arrays = (_arr((B, S, E), 30, 1.0), _arr((E, 128), 31), _arr((128, E), 32),
              _arr((128,), 33), _arr((E,), 34), 1.0 + _arr((E,), 35),
              _arr((E,), 36), 1.0 + _arr((E,), 37), _arr((E,), 38))
    outs = []
    for fn, args in ((TFF.fused_feedforward, _pair(*arrays)[0]),
                     (JFF.fused_feedforward, _pair(*arrays)[1])):
        _seed(39)
        outs.append(fn(*args, dropout1_rate=0.2, dropout2_rate=0.1,
                       activation=act, pre_layer_norm=pre_ln,
                       training=training))
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), **TOL)


def _stack_args(L=2, seed=40):
    D, F = E // H, 128
    per_layer = [
        [1.0 + _arr((E,), seed + 100 * i), _arr((E,), seed + 100 * i + 1),
         _arr((3, H, D, E), seed + 100 * i + 2),
         _arr((3, H, D), seed + 100 * i + 3),
         _arr((E, E), seed + 100 * i + 4), _arr((E,), seed + 100 * i + 5),
         1.0 + _arr((E,), seed + 100 * i + 6),
         _arr((E,), seed + 100 * i + 7), _arr((E, F), seed + 100 * i + 8),
         _arr((F,), seed + 100 * i + 9), _arr((F, E), seed + 100 * i + 10),
         _arr((E,), seed + 100 * i + 11)] for i in range(L)]
    return [list(group) for group in zip(*per_layer)]


def test_fused_multi_transformer_matches_jax():
    x = _arr((B, S, E), 50, 1.0)
    groups = _stack_args()
    got = TFF.fused_multi_transformer(
        torch.tensor(x), *[[torch.tensor(a) for a in g] for g in groups])
    want = JFF.fused_multi_transformer(
        jpaddle.to_tensor(x),
        *[[jpaddle.to_tensor(a) for a in g] for g in groups])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(pre_layer_norm=False), "post-LN"),
    (dict(attn_mask=np.zeros((S, S), np.float32)), "causal-only"),
    (dict(activation="relu"), "activation"),
    (dict(dropout_rate=0.1), "dropout_rate"),
    (dict(trans_qkvw=False), "trans_qkvw"),
    (dict(time_step=1), "kv-cache")])
def test_fused_multi_transformer_raises_as_jax(kw, match):
    x = _arr((B, S, E), 51)
    groups = _stack_args(1)
    for fn, to in ((TFF.fused_multi_transformer, torch.tensor),
                   (JFF.fused_multi_transformer, jpaddle.to_tensor)):
        args = {k: to(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        with pytest.raises(NotImplementedError, match=match):
            fn(to(x), *[[to(a) for a in g] for g in groups], **args)


# --------------------------------------------------------------- layers ---

def _layers(make_j, make_t):
    jpaddle.seed(60)
    jl = make_j()
    return jl, _carry(jl, make_t())


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_encoder_layer_matches_jax(pre_ln, masked):
    jl, tl = _layers(
        lambda: jinn.FusedTransformerEncoderLayer(
            E, H, 128, dropout_rate=0.0, activation="gelu",
            normalize_before=pre_ln),
        lambda: tinn.FusedTransformerEncoderLayer(
            E, H, 128, dropout_rate=0.0, activation="gelu",
            normalize_before=pre_ln))
    x = _arr((B, S, E), 61, 1.0)
    keep = _batch()[2] if masked else None
    (tx, tk), (jx, jk) = _pair(x, keep)
    tx.requires_grad_(True)
    jx.stop_gradient = False
    tout, jout = tl(tx, tk), jl(jx, jk)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    w = _arr((B, S, E), 62, 1.0)
    (tout * torch.tensor(w)).sum().backward()
    (jout * jpaddle.to_tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **TOL)
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        want = jp[n].grad
        if p.grad is None:      # the LayerNorm of the other placement
            assert want is None or not np.any(_np(want)), n
            continue
        np.testing.assert_allclose(_np(p.grad), _np(want), **TOL, err_msg=n)


def test_fused_layers_match_jax():
    x, r = _arr((B, S, E), 70, 1.0), _arr((B, S, E), 71, 1.0)
    (tx, tr), (jx, jr) = _pair(x, r)
    cases = [
        (lambda m: m.FusedLinear(E, 32), (0,)),
        (lambda m: m.FusedLinear(E, 32, transpose_weight=True), (0,)),
        (lambda m: m.FusedMultiHeadAttention(E, H, 0.0, 0.0), (0,)),
        (lambda m: m.FusedMultiHeadAttention(E, H, 0.0, 0.0,
                                             normalize_before=True), (0,)),
        (lambda m: m.FusedFeedForward(E, 128, 0.0), (0,)),
        (lambda m: m.FusedMultiTransformer(E, H, 128, num_layers=2), (0,)),
        (lambda m: m.FusedBiasDropoutResidualLayerNorm(E, 0.0), (0, 1)),
    ]
    for make, which in cases:
        jl, tl = _layers(lambda: make(jinn), lambda: make(tinn))
        targs, jargs = [(tx, tr)[i] for i in which], [(jx, jr)[i]
                                                      for i in which]
        np.testing.assert_allclose(_np(tl(*targs)), _np(jl(*jargs)), **TOL,
                                   err_msg=type(tl).__name__)
    assert set(tinn.__all__) == set(jinn.__all__)


def test_fused_layers_raise_as_jax():
    for m in (tinn, jinn):
        for kw, err in ((dict(normalize_before=False), NotImplementedError),
                        (dict(activation="relu"), NotImplementedError),
                        (dict(dropout_rate=0.1), NotImplementedError),
                        (dict(num_layers=0), ValueError)):
            with pytest.raises(err):
                m.FusedMultiTransformer(E, H, 128, **{"num_layers": 1, **kw})
        with pytest.raises(ValueError, match="divide"):
            m.FusedMultiHeadAttention(E, 5)
    jpaddle.seed(0)
    tl = tinn.FusedMultiHeadAttention(E, H)
    x = torch.tensor(_arr((B, S, E), 80))
    with pytest.raises(NotImplementedError, match="self-attention"):
        tl(x, x + 1.0)
    with pytest.raises(NotImplementedError, match="causal"):
        tinn.FusedMultiTransformer(E, H, 128, num_layers=1)(x, attn_mask=x)
