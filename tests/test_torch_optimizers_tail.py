"""The port's optimizer surface against the JAX package's, on the CPU.

- The repairs: ``parameters=`` as a list of parameter groups (their
  ``"params"`` flattened, other keys ignored, ``(name, parameter)``
  pairs named inside a group too), ``weight_decay=`` as a regularizer
  object (``L2Decay(c)`` steps bit for bit as ``c``; ``L1Decay(c)`` as
  ``L2Decay(c)``, the kept quirk), the keywords the JAX constructors
  take and ignore (Adam's ``lazy_mode`` / ``use_multi_tensor`` /
  ``name``, AdamW's ``lr_ratio``), and every optimizer's constructor
  signature: the JAX parameter names in the JAX order, with the JAX
  defaults.
- ``Adagrad``, ``Adadelta``, ``Adamax``, ``RMSProp`` (centered),
  ``Lamb`` and ``Lars``: three steps on the same parameters and
  gradients as the JAX optimizer, float32 parameters and state at
  rtol = atol = 1e-6; bf16 parameters with a float32 master
  (``multi_precision``: the masters and the state at 1e-6, the bf16
  parameters within one bf16 step of each other) and without one (the
  JAX rule rounds each scalar factor to bf16 where PyTorch rounds the
  product once: the parameters and the state within four bf16 steps of
  each tensor's largest value). Lamb's
  ``exclude_from_weight_decay_fn`` is given the parameter, Lars's
  ``exclude_from_weight_decay`` matches names. ``state_dict`` keys are
  the JAX optimizer's and a round trip resumes the same trajectory.
- ``incubate.optimizer``: ``LookAhead`` (slow weights seeded at the
  first sync point; its ``state_dict`` round trip) and ``ModelAverage``
  (a running mean restarting at ``max_average_window``; ``apply``
  equal to the JAX average, ``restore`` bit-equal to before) over six
  steps against the JAX classes.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.incubate.optimizer as jinc  # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor  # noqa: E402
from paddle_tpu import regularizer as jreg  # noqa: E402
import paddle_tpu_torch.incubate.optimizer as tinc  # noqa: E402
import paddle_tpu_torch.optimizer as topt_mod  # noqa: E402
from paddle_tpu_torch import regularizer as treg  # noqa: E402
from paddle_tpu_torch.nn import Parameter  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"fc.weight": (8, 12), "fc.bias": (12,), "ln.weight": (12,),
          "emb.weight": (16, 8)}
NEW = ("Adagrad", "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars")
ALL = ("Optimizer", "SGD", "Momentum", "Adam", "AdamW", *NEW,
       "HostOffloadAdamW")


def _data(steps=3, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: (rng.standard_normal(s) * 0.01).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return arrays, grads


def _params(arrays, dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = [JTensor(jnp.asarray(a, jdt), stop_gradient=False, name=n)
          for n, a in arrays.items()]
    tp = [Parameter(torch.tensor(a).to(getattr(torch, dtype)))
          for a in arrays.values()]
    return jp, tp


def _set_grads(jp, tp, g, dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    for p, arr in zip(jp, g.values()):
        p.grad = JTensor(jnp.asarray(arr, jdt))
    for p, arr in zip(tp, g.values()):
        p.grad = torch.tensor(arr).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x._value if isinstance(x, JTensor) else x, np.float32)


def _kwargs(name, jp, tp, multi_precision):
    """The constructor arguments of each optimizer in both packages."""
    names = list(SHAPES)
    jkw, tkw = {}, {}
    mp = {"multi_precision": multi_precision}
    if name == "Adagrad":
        jkw = dict(learning_rate=0.05, weight_decay=0.01,
                   initial_accumulator_value=0.1)
    elif name == "Adadelta":
        jkw = dict(learning_rate=1.0, weight_decay=0.01, rho=0.9)
    elif name == "Adamax":
        jkw = dict(learning_rate=0.01, weight_decay=0.01)
    elif name == "RMSProp":
        jkw = dict(learning_rate=0.01, momentum=0.9, centered=True,
                   weight_decay=0.01)
    elif name == "Lamb":
        jkw = dict(learning_rate=0.01, lamb_weight_decay=0.05, **mp)
        bias = {id(p) for n, p in zip(names, tp) if "bias" in n}
        tkw = dict(exclude_from_weight_decay_fn=lambda p: id(p) in bias)
        jkw["exclude_from_weight_decay_fn"] = lambda p: "bias" in p.name
    elif name == "Lars":
        jkw = dict(learning_rate=0.1, lars_weight_decay=0.01,
                   exclude_from_weight_decay=["bias", "ln."], **mp)
    return jkw, {**jkw, **tkw}


def _run(name, dtype="float32", multi_precision=False, steps=3):
    arrays, grads = _data(steps)
    jp, tp = _params(arrays, dtype)
    jkw, tkw = _kwargs(name, jp, tp, multi_precision)
    jopt = getattr(jpaddle.optimizer, name)(parameters=jp, **jkw)
    topt = getattr(topt_mod, name)(
        parameters=list(zip(SHAPES, tp)), **tkw)
    if multi_precision:
        # the four constructors without the argument take a master all the
        # same (the base class's), in both packages
        jopt._multi_precision = topt._multi_precision = True
    for g in grads:
        _set_grads(jp, tp, g, dtype)
        jopt.step()
        topt.step()
        topt.clear_grad()
    return jp, tp, jopt, topt


def _near_bf16(got, want, what):
    """Without a master the JAX rule rounds each scalar factor to bf16
    before its product, PyTorch rounds the product once; a parameter
    whose update cancels most of it then differs by many of its own
    ulps, and a state of squared updates (Adadelta's) by two steps of the
    tensor's scale: held within four bf16 steps of the tensor's largest
    value."""
    tol = 2.0 ** -6 * np.abs(want).max() + 1e-30
    assert np.all(np.abs(got - want) <= tol), what


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("dtype,multi_precision", [
    ("float32", False), ("bfloat16", True), ("bfloat16", False)])
def test_new_optimizers_match_jax(name, dtype, multi_precision):
    jp, tp, jopt, topt = _run(name, dtype, multi_precision)
    for j, t in zip(jp, tp):
        jst, tst = jopt._state_for(j), topt._state_for(t)
        assert set(tst) == set(jst), j.name
        exact = dtype == "float32" or multi_precision
        for key in tst:
            want = _f32(jst[key])
            if exact or key.endswith("_pow"):
                np.testing.assert_allclose(_f32(tst[key]), want, **TOL,
                                           err_msg=f"{name} {j.name} {key}")
            else:
                _near_bf16(_f32(tst[key]), want, f"{name} {j.name} {key}")
        if dtype == "float32":
            np.testing.assert_allclose(_f32(t), _f32(j), **TOL,
                                       err_msg=f"{name} {j.name}")
        elif multi_precision:
            assert t.dtype == torch.bfloat16
            step = np.abs(_f32(j)) * 2.0 ** -8 + 1e-30
            assert np.all(np.abs(_f32(t) - _f32(j)) <= step), j.name
        else:
            assert t.dtype == torch.bfloat16
            _near_bf16(_f32(t), _f32(j), f"{name} {j.name}")
    assert topt._global_step == 3


@pytest.mark.parametrize("name", NEW)
def test_new_optimizers_state_dict_round_trip(name):
    """The keys are the JAX optimizer's; an optimizer loaded from the
    state of two steps takes the third step as the first one does."""
    jp, tp, jopt, topt = _run(name, steps=2)
    sd = topt.state_dict()
    assert set(sd) == set(jopt.state_dict())
    arrays, grads = _data(3)
    _, resumed_p = _params({n: _f32(t) for n, t in zip(SHAPES, tp)})
    _, tkw = _kwargs(name, jp, resumed_p, False)
    resumed = getattr(topt_mod, name)(
        parameters=list(zip(SHAPES, resumed_p)), **tkw)
    resumed.set_state_dict(sd)
    for opt, ps in ((topt, tp), (resumed, resumed_p)):
        _set_grads([], ps, grads[2])
        opt.step()
    for a, b in zip(tp, resumed_p):
        assert torch.equal(a, b)


def _sig(cls):
    return [(n, p.default) for n, p in
            inspect.signature(cls.__init__).parameters.items()]


@pytest.mark.parametrize("name", ALL)
def test_signatures_match_jax(name):
    """The JAX parameter names, in the JAX order, with its defaults."""
    assert _sig(getattr(topt_mod, name)) == _sig(
        getattr(jpaddle.optimizer, name))


def _step_both(make, groups_j, groups_t, jp, tp, steps=3, dtype="float32"):
    _, grads = _data(steps)
    jopt, topt = make(jpaddle.optimizer, groups_j), make(topt_mod, groups_t)
    for g in grads:
        _set_grads(jp, tp, g, dtype)
        jopt.step()
        topt.step()
        topt.clear_grad()


@pytest.mark.parametrize("name", ["AdamW", "Momentum", "Lamb"])
def test_param_groups_step_as_jax(name):
    """Groups flattened, per-group keys ignored (as in the JAX package);
    (name, parameter) pairs inside a group keep their names."""
    arrays, _ = _data()
    jp, tp = _params(arrays)
    names = list(SHAPES)

    def make(mod, groups):
        kw = (dict(apply_decay_param_fun=lambda n: "bias" not in n)
              if name == "AdamW" else {})
        return getattr(mod, name)(learning_rate=0.01, parameters=groups,
                                  **kw)

    jgroups = [{"params": jp[:2], "learning_rate": 5.0},
               {"params": jp[2:], "weight_decay": 0.5}]
    tgroups = [{"params": list(zip(names[:2], tp[:2])), "learning_rate": 5.0},
               {"params": list(zip(names[2:], tp[2:])), "weight_decay": 0.5}]
    _step_both(make, jgroups, tgroups, jp, tp)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(_f32(t), _f32(j), **TOL, err_msg=j.name)


def test_param_groups_of_plain_parameters():
    arrays, grads = _data(1)
    _, flat = _params(arrays)
    _, grouped = _params(arrays)
    a = topt_mod.SGD(0.1, parameters=flat)
    b = topt_mod.SGD(0.1, parameters=[{"params": grouped[:1]},
                                      {"params": grouped[1:]}])
    for opt, ps in ((a, flat), (b, grouped)):
        _set_grads([], ps, grads[0])
        opt.step()
    assert all(torch.equal(x, y) for x, y in zip(flat, grouped))
    assert b._parameter_list == grouped


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW",
                                  "Adagrad", "RMSProp"])
@pytest.mark.parametrize("reg", ["L2Decay", "L1Decay"])
def test_regularizer_objects_decay_as_their_coefficient(name, reg):
    """``weight_decay=L2Decay(c)`` (and ``L1Decay(c)``, the kept quirk)
    steps bit for bit as ``weight_decay=c`` and as the JAX optimizer
    given the JAX regularizer."""
    arrays, grads = _data()
    lr = {"SGD": 0.1, "Momentum": 0.1}.get(name, 0.01)
    runs = []
    for wd in (0.05, getattr(treg, reg)(0.05)):
        _, tp = _params(arrays)
        opt = getattr(topt_mod, name)(learning_rate=lr, parameters=tp,
                                      weight_decay=wd)
        for g in grads:
            _set_grads([], tp, g)
            opt.step()
        runs.append(tp)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    jp, _ = _params(arrays)
    jopt = getattr(jpaddle.optimizer, name)(
        learning_rate=lr, parameters=jp, weight_decay=getattr(jreg, reg)(0.05))
    for g in grads:
        _set_grads(jp, [], g)
        jopt.step()
    for j, t in zip(jp, runs[1]):
        np.testing.assert_allclose(_f32(t), _f32(j), **TOL)


def test_jax_keywords_are_accepted_and_change_nothing():
    arrays, grads = _data()
    runs = []
    for extra in ({}, dict(lazy_mode=True, use_multi_tensor=True, name="a")):
        _, tp = _params(arrays)
        opt = topt_mod.Adam(0.01, parameters=tp, **extra)
        for g in grads:
            _set_grads([], tp, g)
            opt.step()
        runs.append(tp)
    for extra in ({}, dict(lr_ratio=lambda p: 0.5, lazy_mode=True,
                           name="b")):
        _, tp = _params(arrays)
        opt = topt_mod.AdamW(0.01, parameters=tp, **extra)
        for g in grads:
            _set_grads([], tp, g)
            opt.step()
        runs.append(tp)
    for a, b in ((runs[0], runs[1]), (runs[2], runs[3])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_lookahead_matches_jax_and_round_trips():
    arrays, grads = _data(6)
    jp, tp = _params(arrays)
    jla = jinc.LookAhead(jpaddle.optimizer.SGD(0.1, parameters=jp), 0.5, 2)
    tla = tinc.LookAhead(topt_mod.SGD(0.1, parameters=list(zip(SHAPES, tp))),
                         0.5, 2)
    for i, g in enumerate(grads):
        _set_grads(jp, tp, g)
        jla.step()
        tla.step()
        tla.clear_grad()
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(_f32(t), _f32(j), **TOL,
                                       err_msg=f"step {i}")
        if i == 2:
            sd = tla.state_dict()
    assert sd["lookahead_step"] == 3 and set(sd["lookahead_slow"]) == {
        0, 1, 2, 3}
    _, again = _params({n: _f32(t) for n, t in zip(SHAPES, tp)})
    la2 = tinc.LookAhead(topt_mod.SGD(0.1, parameters=again), 0.5, 2)
    la2.set_state_dict(sd)
    assert la2._step_count == 3
    for i in range(4):
        assert torch.equal(la2._slow[id(again[i])],
                           sd["lookahead_slow"][i])


def test_model_average_matches_jax_and_restores_bits():
    arrays, grads = _data(5)
    jp, tp = _params(arrays)
    jopt = jpaddle.optimizer.SGD(0.1, parameters=jp)
    topt = topt_mod.SGD(0.1, parameters=tp)
    jma = jinc.ModelAverage(0.15, parameters=jp, max_average_window=3)
    tma = tinc.ModelAverage(0.15, parameters=tp, max_average_window=3)
    for g in grads:
        _set_grads(jp, tp, g)
        jopt.step()
        topt.step()
        jma.step()
        tma.step()
    assert tma._count == jma._count == 2      # restarted after three
    before = [t.detach().clone() for t in tp]
    jma.apply()
    tma.apply()
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(_f32(t), _f32(j), **TOL)
    tma.restore()
    assert all(torch.equal(a, b) for a, b in zip(tp, before))
