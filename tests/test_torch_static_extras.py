"""The port's ``static.sequence`` ops and static tail against the JAX
package's, on the CPU.

- every sequence op (``sequence_softmax`` ... ``sequence_conv``) on the
  same seeded padded batches and lengths: float results at 1e-6, index
  and integer results equal; the shape-static ops also recorded into a
  static program and replayed by the ``Executor``, equal to their eager
  results;
- ``accuracy``, ``auc`` and ``ctr_metric_bundle`` at 1e-6;
  ``exponential_decay``'s rates equal;
- ``ExponentialMovingAverage``: the shadows through updates and the
  bias-corrected ``apply`` at 1e-6 of the JAX package's (float32), and
  ``restore`` puts the parameters back bit for bit; on a static program
  it reads the program's parameters by default;
- program serialization (``serialize_program`` outlines the port's
  torch-level records), ``serialize_persistables`` /
  ``deserialize_persistables`` and ``static.save`` / ``load`` round trips
  bit-equal (bfloat16 parameters included); places, guards, parameters,
  global variables, ``Print``, ``py_func``, the strategy bags and
  ``ParallelExecutor``.
"""
import contextlib
import io
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu.static import sequence as jseq  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.static as tstatic  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.static import sequence as tseq  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-6


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy() if x.dtype != torch.bfloat16 else \
            x.detach().float().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _close(j, t):
    j, t = _np(j), _np(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if np.issubdtype(t.dtype, np.floating):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64))


def _pair_out(j, t):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _close(a, b)
    else:
        _close(j, t)


# ------------------------------------------------------------ sequences ---


_R = np.random.RandomState(0)
X2 = _R.randn(3, 6).astype(np.float32)
X3 = _R.randn(3, 6, 4).astype(np.float32)
LEN = np.array([6, 2, 4], np.int64)
IDS = _R.randint(0, 50, (3, 6)).astype(np.int64)
W = _R.randn(3 * 4, 5).astype(np.float32)
BIAS = _R.randn(5).astype(np.float32)
FLAT = _R.randn(12, 4).astype(np.float32)

SEQ_OPS = {
    "softmax": (lambda s, t: s.sequence_softmax(t(X2), t(LEN))),
    "softmax_nolen": (lambda s, t: s.sequence_softmax(t(X2))),
    **{f"pool_{k}_{d}": (lambda s, t, k=k, x=x: s.sequence_pool(
        t(x), k, length=t(LEN)))
       for k in ("sum", "average", "sqrt", "max", "min", "first", "last")
       for d, x in (("2d", X2), ("3d", X3))},
    "pool_nolen": (lambda s, t: s.sequence_pool(t(X3), "average")),
    "first_step": (lambda s, t: s.sequence_first_step(t(X3), t(LEN))),
    "last_step": (lambda s, t: s.sequence_last_step(t(X3), t(LEN))),
    "reverse": (lambda s, t: s.sequence_reverse(t(X3), t(LEN))),
    "reverse_nolen": (lambda s, t: s.sequence_reverse(t(X2))),
    "concat": (lambda s, t: s.sequence_concat(
        [t(X3), t(X3[:, :4] * 2)], [t(LEN), t(np.array([1, 4, 0]))])),
    "concat_nolen": (lambda s, t: s.sequence_concat([t(X2), t(X2)])),
    "expand": (lambda s, t: s.sequence_expand(t(X3[:, 0]), t(LEN))),
    "expand_as": (lambda s, t: s.sequence_expand_as(t(X2), t(FLAT))),
    "pad": (lambda s, t: s.sequence_pad(t(FLAT), 0.5, length=t(LEN))),
    "pad_maxlen": (lambda s, t: s.sequence_pad(t(FLAT), t(np.array(
        [-1.0], np.float32)), maxlen=7, length=t(LEN))),
    "unpad": (lambda s, t: s.sequence_unpad(t(X3), t(LEN))),
    "reshape": (lambda s, t: s.sequence_reshape(t(FLAT), 8)),
    "slice": (lambda s, t: s.sequence_slice(
        t(X3), t(np.array([1, 0, 3])), t(np.array([2, 2, 3])))),
    "scatter": (lambda s, t: s.sequence_scatter(
        t(FLAT), t(np.array([1, 5, 1])), t(FLAT[:3] * 3))),
    "enumerate": (lambda s, t: s.sequence_enumerate(t(IDS), 3, pad_value=-1)),
    "conv": (lambda s, t: s.sequence_conv(t(X3), 5, 3, weight=t(W))),
    "conv_len_bias_relu": (lambda s, t: s.sequence_conv(
        t(X3), 5, 3, weight=t(W), bias=t(BIAS), length=t(LEN), act="relu")),
    "conv_start_tanh": (lambda s, t: s.sequence_conv(
        t(X3), 5, 3, padding_start=0, weight=t(W), length=t(LEN),
        act="tanh")),
}


@pytest.mark.parametrize("name", sorted(SEQ_OPS))
def test_sequence_op_matches_jax(name):
    fn = SEQ_OPS[name]
    _pair_out(fn(jseq, jp.to_tensor), fn(tseq, tp.to_tensor))


# the shape-static ops, recorded: name -> (fn(seq, x, length), x array)
RECORDED = {
    "softmax": (lambda s, x, n: s.sequence_softmax(x, n), X2),
    "pool_max": (lambda s, x, n: s.sequence_pool(x, "max", length=n), X3),
    "pool_sqrt": (lambda s, x, n: s.sequence_pool(x, "sqrt", length=n), X3),
    "last_step": (lambda s, x, n: s.sequence_last_step(x, n), X3),
    "reverse": (lambda s, x, n: s.sequence_reverse(x, n), X3),
    "concat": (lambda s, x, n: s.sequence_concat([x, x], [n, n])[0], X3),
    "expand_as": (lambda s, x, n: s.sequence_expand_as(x, x), X3),
    "conv": (lambda s, x, n: s.sequence_conv(
        x, 5, 3, weight=tp.to_tensor(W), length=n), X3),
}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_sequence_op_under_the_recorder(name):
    fn, x = RECORDED[name]
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        xv = tstatic.data("x", [None] + list(x.shape[1:]), "float32")
        nv = tstatic.data("n", [None], "int64")
        out = fn(tseq, xv, nv)
    assert any(r.op_name.startswith("sequence_") for r in main.ops)
    exe = tstatic.Executor()
    got = exe.run(main, feed={"x": x, "n": LEN}, fetch_list=[out])[0]
    want = fn(tseq, tp.to_tensor(x), tp.to_tensor(LEN))
    np.testing.assert_array_equal(got, want.numpy())


# ------------------------------------------------------ metrics and LR ---


def test_static_metrics_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(30, 6).astype(np.float32)
    label = rng.randint(0, 6, (30, 1)).astype(np.int64)
    p2 = rng.rand(30, 2).astype(np.float32)
    p2 /= p2.sum(1, keepdims=True)
    y = rng.randint(0, 2, (30, 1)).astype(np.int64)
    for k in (1, 3):
        _close(jstatic.accuracy(jp.to_tensor(logits), jp.to_tensor(label),
                                k=k),
               tstatic.accuracy(tp.to_tensor(logits), tp.to_tensor(label),
                                k=k))
    for probs in (p2, p2[:, 1:]):
        ja, _ = jstatic.auc(jp.to_tensor(probs), jp.to_tensor(y))
        ta, extra = tstatic.auc(tp.to_tensor(probs), tp.to_tensor(y))
        _close(ja, ta)
        assert extra == []
    _pair_out(jstatic.ctr_metric_bundle(jp.to_tensor(p2), jp.to_tensor(y)),
              tstatic.ctr_metric_bundle(tp.to_tensor(p2), tp.to_tensor(y)))


@pytest.mark.parametrize("staircase", [False, True])
def test_exponential_decay_matches_jax(staircase):
    rates = []
    for static in (jstatic, tstatic):
        s = static.exponential_decay(0.1, 3, 0.5, staircase=staircase)
        run = []
        for _ in range(7):
            run.append(s())
            s.step()
        rates.append(run)
    assert rates[0] == rates[1]


# ------------------------------------------------------------------ EMA ---


def _jset(p, arr):
    p._value = jnp.asarray(arr)


def test_ema_matches_jax_and_restores_bits():
    rng = np.random.RandomState(2)
    init = [rng.randn(4, 3).astype(np.float32),
            rng.randn(3).astype(np.float32)]
    jps = [jp.create_parameter(list(a.shape), "float32") for a in init]
    tps = [tstatic.create_parameter(list(a.shape), "float32") for a in init]
    jema = jstatic.ExponentialMovingAverage(0.9)
    tema = tstatic.ExponentialMovingAverage(0.9)
    for step in range(4):
        vals = [a + 0.1 * step * rng.randn(*a.shape).astype(np.float32)
                for a in init]
        for jpar, tpar, v in zip(jps, tps, vals):
            _jset(jpar, v)
            with torch.no_grad():
                tpar.copy_(torch.from_numpy(v))
        jema.update(jps)
        tema.update(tps)
    before = [t.detach().clone() for t in tps]
    with jema.apply(), tema.apply():
        for jpar, tpar, b in zip(jps, tps, before):
            _close(np.asarray(jpar._value), tpar)
            assert not torch.equal(tpar, b)
    for tpar, b in zip(tps, before):
        assert torch.equal(tpar, b)
    # apply without restore, then restore by hand
    with tema.apply(need_restore=False):
        pass
    assert not torch.equal(tps[0], before[0])
    tema.restore()
    assert torch.equal(tps[0], before[0])


def test_ema_on_a_static_program():
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [None, 4], "float32")
        loss = (tstatic.nn.fc(x, 3) ** 2).mean()
        tp.optimizer.Adam(0.1).minimize(loss)
    exe = tstatic.Executor()
    exe.run(startup)
    ema = tstatic.ExponentialMovingAverage(0.5)
    params = main.all_parameters()
    shadows = [p.detach().clone() for p in params]
    rng = np.random.RandomState(3)
    with tstatic.program_guard(main, startup):
        for step in range(3):
            exe.run(main, feed={"x": rng.randn(5, 4).astype(np.float32)},
                    fetch_list=[loss])
            ema.update()
            for i, p in enumerate(params):
                shadows[i] = (p.detach().clone() if step == 0 else
                              0.5 * shadows[i] + 0.5 * p.detach())
    trained = [p.detach().clone() for p in params]
    with ema.apply():
        for p, s in zip(params, shadows):
            np.testing.assert_allclose(p.detach().numpy(),
                                       (s / (1 - 0.5 ** 3)).numpy(),
                                       rtol=TOL, atol=TOL)
    for p, t in zip(params, trained):
        assert torch.equal(p, t)


# ------------------------------------------------------- serialization ---


def _program(dtype="float32"):
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [None, 4], dtype)
        h = tstatic.nn.fc(x, 6, activation="relu")
        out = tstatic.sequence_softmax(h, tstatic.data("n", [None], "int64"))
    exe = tstatic.Executor()
    exe.run(startup)
    return main, out, exe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_round_trips(tmp_path, dtype):
    main, out, exe = _program()
    if dtype == "bfloat16":
        with torch.no_grad():
            for p in main.all_parameters():
                p.data = p.data.to(torch.bfloat16)
    params = main.all_parameters()
    saved = [p.detach().clone() for p in params]
    blob = tstatic.serialize_persistables(program=main)
    tstatic.save(main, str(tmp_path / "m"))
    meta = tstatic.deserialize_program(tstatic.serialize_program(
        program=main))
    assert meta["n_params"] == len(params) == 2
    assert meta["n_ops"] == len(main.ops)
    assert "sequence_softmax" in meta["op_names"]
    with torch.no_grad():
        for p in params:
            p.zero_()
    tstatic.deserialize_persistables(main, blob)
    for p, s in zip(params, saved):
        assert p.dtype == s.dtype and torch.equal(p, s)
    with torch.no_grad():
        for p in params:
            p.add_(1)
    tstatic.load(main, str(tmp_path / "m"))
    for p, s in zip(params, saved):
        assert torch.equal(p, s)
    state = tstatic.load_program_state(str(tmp_path / "m"))
    assert sorted(state) == ["param_0", "param_1"]
    with open(tmp_path / "m.pdmodel", "rb") as f:
        assert pickle.loads(f.read()) == meta
    tstatic.save_to_file(str(tmp_path / "b"), blob)
    assert tstatic.load_from_file(str(tmp_path / "b")) == blob
    assert tstatic.normalize_program(main, [], []) is main


def test_serialize_matches_jax_layout():
    """Both packages pickle the same outline keys and a name -> array
    state; the op names are each package's own."""
    jmain, jstartup = jstatic.Program(), jstatic.Program()
    with jstatic.program_guard(jmain, jstartup):
        jx = jstatic.data("x", [None, 4], "float32")
        jstatic.nn.fc(jx, 6)
    tmain, _, _ = _program()
    jmeta = pickle.loads(jstatic.serialize_program(program=jmain))
    tmeta = pickle.loads(tstatic.serialize_program(program=tmain))
    assert set(jmeta) == set(tmeta)
    assert jmeta["n_params"] == tmeta["n_params"] == 2
    jstate = pickle.loads(jstatic.serialize_persistables(program=jmain))
    tstate = pickle.loads(tstatic.serialize_persistables(program=tmain))
    assert sorted(a.shape for a in jstate.values()) == \
        sorted(a.shape for a in tstate.values())


# --------------------------------------------------------------- the rest --


def test_places_guards_and_variables():
    assert tstatic.cpu_places(2) == [torch.device("cpu")] * 2
    assert len(jstatic.cpu_places(2)) == 2
    places = tstatic.cuda_places()
    assert all(isinstance(p, torch.device) for p in places)
    if not torch.cuda.is_available():
        assert places == [torch.device("cpu")]
    for static in (jstatic, tstatic):
        for fn in (static.xpu_places, static.npu_places, static.mlu_places):
            with pytest.raises(RuntimeError):
                fn()
        with pytest.raises(RuntimeError):
            static.IpuStrategy()
        with pytest.raises(RuntimeError):
            with static.ipu_shard_guard():
                pass
    with tstatic.name_scope("block"), tstatic.device_guard("gpu"):
        v = tstatic.create_global_var([2, 3], 1.5, "float32", name="g")
    assert v.name == "g" and v.numpy().tolist() == [[1.5] * 3] * 2
    _close(jstatic.create_global_var([2, 3], 1.5, "float32"), v)
    p = tstatic.create_parameter([3, 2], "float32", name="w", is_bias=True)
    assert p.name == "w" and not p.stop_gradient
    assert torch.equal(p, torch.zeros(3, 2))
    bs = tstatic.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    assert bs.fuse_all_reduce_ops is True and bs.unknown is None
    tstatic.WeightNormParamAttr(dim=0, name="wn")


def test_print_py_func_and_parallel_executor(capsys):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = tstatic.Print(tp.to_tensor(x), message="eager")
    assert torch.equal(out, tp.to_tensor(x))
    assert "eager:" in capsys.readouterr().out
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        xv = tstatic.data("x", [None, 3], "float32")
        shown = tstatic.Print(xv * 2, message="static")
        doubled = tstatic.py_func(lambda a: a + 1.0, shown,
                                  tstatic.data("o", [2, 3], "float32"))
    assert capsys.readouterr().out == ""      # recorded, not run
    pe = tstatic.ParallelExecutor(main_program=main)
    got = pe.run(fetch_list=[doubled], feed={"x": x})[0]
    np.testing.assert_array_equal(got, x * 2 + 1)
    assert "static:" in capsys.readouterr().out
    # the JAX Print passes its value through too
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jout = jstatic.Print(jp.to_tensor(x), message="jax")
    _close(jout, out)
