"""The ``Layer``, gradient-clearing and ``Embedding`` repairs against the
JAX package, on the CPU.

- ``Layer.sublayers(include_self)`` (the same layer types in the same
  order), ``add_parameter``, ``load_dict``, ``astype`` and
  ``full_name`` (the JAX naming scheme);
- ``Optimizer.clear_grad(set_to_zero)`` and its alias
  ``clear_gradients`` on SGD, Adam, AdamW and the host-offload AdamW
  (whose step drops each gradient, in both packages), and
  ``LookAhead(opt).clear_grad(set_to_zero=True)``: the same gradients
  afterwards (zeros, or none), and the next step's update
  equal to the JAX package's within 1e-6;
- ``nn.Embedding``'s JAX signature ``(num_embeddings, embedding_dim,
  padding_idx=None, sparse=False, weight_attr=None, name=None)``:
  ``sparse`` accepted (and ignored), positional arguments landing where
  the JAX package puts them, lookups equal.

Weights pass from the JAX layers to the port's as numpy arrays; values
are compared within rtol / atol 1e-6 (float32, the same arithmetic).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.incubate as jinc  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.incubate as tinc  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-6


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _mlp(p):
    return p.nn.Sequential(p.nn.Linear(4, 8), p.nn.ReLU(), p.nn.Linear(8, 3))


def _same_weights(jm, tm):
    tm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})


@pytest.mark.parametrize("include_self", [False, True])
def test_sublayers_match_jax(include_self):
    j, t = _mlp(jp), _mlp(tp)
    js = [type(m).__name__ for m in j.sublayers(include_self=include_self)]
    ts = [type(m).__name__ for m in t.sublayers(include_self=include_self)]
    assert ts == js
    assert len(ts) == (4 if include_self else 3)


def test_full_name_matches_jax():
    for build in (_mlp, lambda p: p.nn.Linear(2, 2),
                  lambda p: p.nn.Layer(name_scope="encoder"),
                  lambda p: p.nn.LayerNorm(4)):
        assert build(tp).full_name() == build(jp).full_name()


def test_add_parameter_and_load_dict_match_jax():
    x = np.random.default_rng(0).standard_normal((5, 4)).astype("float32")
    j, t = _mlp(jp), _mlp(tp)
    extra = np.full([3], 0.25, "float32")
    for p, m in ((jp, j), (tp, t)):
        w = p.create_parameter([3], "float32",
                               default_initializer=p.nn.initializer.Assign(
                                   extra))
        assert m.add_parameter("offset", w) is w
    assert sorted(t.state_dict()) == sorted(j.state_dict())
    missing, unexpected = t.load_dict({k: np.asarray(v.numpy())
                                       for k, v in j.state_dict().items()})
    assert missing == [] and unexpected == []
    np.testing.assert_allclose(
        (t(tp.to_tensor(x)) + t.offset).detach().numpy(),
        (j(jp.to_tensor(x)) + j.offset).numpy(), rtol=TOL, atol=TOL)


def test_astype_matches_jax():
    j, t = _mlp(jp), _mlp(tp)
    _same_weights(j, t)
    assert t.astype("bfloat16") is t
    j.astype("bfloat16")
    for (jn, jv), (tn, tv) in zip(sorted(j.state_dict().items()),
                                  sorted(t.state_dict().items())):
        assert jn == tn and str(tv.dtype) == "torch.bfloat16"
        np.testing.assert_array_equal(tv.float().numpy(),
                                      np.asarray(jv.numpy(), "float32"))


def _optimizer(p, kind, params):
    if kind == "SGD":
        return p.optimizer.SGD(0.1, parameters=params)
    if kind == "Adam":
        return p.optimizer.Adam(0.01, parameters=params)
    if kind == "AdamW":
        return p.optimizer.AdamW(0.01, parameters=params, weight_decay=0.1)
    if kind == "HostOffloadAdamW":
        return p.optimizer.HostOffloadAdamW(0.01, parameters=params)
    if kind == "LookAhead":
        inc = jinc if p is jp else tinc
        return inc.LookAhead(p.optimizer.SGD(0.1, parameters=params),
                             alpha=0.5, k=2)
    raise KeyError(kind)


def _grads(m):
    return [None if q.grad is None else np.array(q.grad.numpy())
            for q in m.parameters()]


@pytest.mark.parametrize("kind", ["SGD", "Adam", "AdamW",
                                  "HostOffloadAdamW", "LookAhead"])
def test_clear_grad_set_to_zero_and_clear_gradients_match_jax(kind):
    x = np.random.default_rng(1).standard_normal((6, 4)).astype("float32")
    j, t = _mlp(jp), _mlp(tp)
    _same_weights(j, t)
    runs = {}
    for p, m in ((jp, j), (tp, t)):
        opt = _optimizer(p, kind, m.parameters())
        seen = []
        for clear in ("zero", "drop"):
            loss = (m(p.to_tensor(x)) ** 2).mean()
            loss.backward()
            opt.step()
            if clear == "zero":
                opt.clear_grad(set_to_zero=True)
            else:
                opt.clear_gradients()
            seen.append(_grads(m))
        runs[p] = seen, [np.asarray(q.detach().numpy() if p is tp
                                    else q.numpy()) for q in m.parameters()]
    (jseen, jw), (tseen, tw) = runs[jp], runs[tp]
    for g in jseen[0]:      # the offload optimizer's step drops them
        assert (g is None if kind == "HostOffloadAdamW"
                else g is not None and not g.any())
    assert all(g is None for g in jseen[1])
    for jg, tg in zip(jseen, tseen):
        assert [g is None for g in tg] == [g is None for g in jg]
        for a, b in zip(tg, jg):
            if b is not None:
                np.testing.assert_array_equal(a, b)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_layer_clear_gradients_and_parameter_clear_gradient():
    t = _mlp(tp)
    (t(tp.rand([2, 4])) ** 2).sum().backward()
    w = t[0].weight
    w.clear_gradient(set_to_zero=True)
    assert w.grad is not None and not w.grad.any()
    t.clear_gradients()
    assert all(q.grad is None for q in t.parameters())


@pytest.mark.parametrize("args", [
    (10, 4), (10, 4, None, True), (10, 4, 2, False),
    (10, 4, None, True, "attr"), (10, 4, -1, True, "attr", "emb")])
def test_embedding_signature_matches_jax(args):
    ids = np.array([[0, 2, 9], [3, 2, 1]], "int64")
    tables = {}
    for p in (jp, tp):
        a = [p.ParamAttr(initializer=p.nn.initializer.Assign(
            np.arange(40, dtype="float32").reshape(10, 4) / 40))
             if v == "attr" else v for v in args]
        emb = p.nn.Embedding(*a)
        if "attr" not in args:
            emb.weight.set_value(np.arange(40, dtype="float32").reshape(
                10, 4) / 10)
        tables[p] = (np.asarray(emb.weight.detach().numpy() if p is tp
                                else emb.weight.numpy()),
                     np.asarray(emb(p.to_tensor(ids)).detach().numpy()
                                if p is tp else emb(p.to_tensor(ids)).numpy()))
    for a, b in zip(tables[tp], tables[jp]):
        np.testing.assert_array_equal(a, b)


def test_embedding_sparse_keyword_trains_like_jax():
    ids = np.array([1, 3, 3, 7], "int64")
    out = {}
    for p in (jp, tp):
        emb = p.nn.Embedding(10, 4, sparse=True)
        emb.weight.set_value(np.ones((10, 4), "float32"))
        opt = p.optimizer.SGD(0.5, parameters=emb.parameters())
        (emb(p.to_tensor(ids)) ** 2).sum().backward()
        opt.step()
        out[p] = np.asarray(emb.weight.detach().numpy() if p is tp
                            else emb.weight.numpy())
    np.testing.assert_allclose(out[tp], out[jp], rtol=TOL, atol=TOL)
