"""The port's static-graph API against the JAX package's, on the CPU.

Each program is built once per package by the same builder (the
``paddle.static`` surface both share); the port's parameters take the
JAX program's values (in ``all_parameters()`` order), and both
Executors run the same seeded numpy feeds:

- recording (op records, ``Variable.shape`` with ``-1`` for an unknown
  dim, the parameters, the startup program), the mode flags, symbolic
  Variables refusing ``numpy`` and ``backward``;
- the Executor's forward (fetch by Variable and by name), training with
  ``minimize`` (Adam), the startup program restoring the parameters,
  ``append_backward`` and ``gradients`` (w.r.t. parameters and data),
  ``clone(for_test=True)`` (no backward, dropout off or scaled);
- ``static.nn``: ``fc``, ``embedding``, ``conv2d`` + ``batch_norm``,
  ``layer_norm``, ``cond`` / ``switch_case`` on a recorded predicate
  (the select path) and ``while_loop`` under ``torch.export``, against
  the JAX package's ``to_static`` of the same control flow;
- ``save_inference_model`` / ``load_inference_model`` (two batch sizes
  from one artifact, a batch dim shared by two feeds, the loaded
  program callable with numpy arrays); AMP O1 casts recorded with the
  parameters live inputs; ``scope_guard``.

float32 at rtol = atol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.static as jstatic  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.nn as tnn  # noqa: E402
import paddle_tpu_torch.static as tstatic  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": (jpaddle, jstatic, jnn), "port": (tpaddle, tstatic, tnn)}


@pytest.fixture(autouse=True)
def _static_cpu():
    from paddle_tpu_torch.core import device as tdevice

    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    jpaddle.enable_static()
    tpaddle.enable_static()
    yield
    jpaddle.disable_static()
    tpaddle.disable_static()
    tdevice._CURRENT[0] = saved


def _arr(p):
    return np.asarray(p._value) if hasattr(p, "_value") else \
        p.detach().numpy()


def _copy_params(jprog, tprog):
    jps, tps = jprog.all_parameters(), tprog.all_parameters()
    assert len(jps) == len(tps)
    with torch.no_grad():
        for j, t in zip(jps, tps):
            assert tuple(np.shape(_arr(j))) == tuple(t.shape)
            t.copy_(torch.tensor(_arr(j)))


def _linreg(P, static, nn):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [None, 4], "float32")
        y = static.data("y", [None, 1], "float32")
        h = static.nn.fc(x, 8, activation="relu")
        pred = static.nn.fc(h, 1)
        loss = ((pred - y) ** 2).mean()
    return main, startup, x, y, pred, loss


def _both(build):
    out = {k: build(*PKGS[k]) for k in PKGS}
    _copy_params(out["jax"][0], out["port"][0])
    return out


def _feeds(seed, n=5):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 4)).astype(np.float32),
            "y": rng.standard_normal((n, 1)).astype(np.float32)}


class TestRecord:
    def test_record(self):
        main, startup, x, y, pred, loss = _linreg(*PKGS["port"])
        assert len(main.ops) >= 4
        assert x.shape == [-1, 4] and loss.shape == []
        assert main.global_block().has_var("x")
        assert len(main.all_parameters()) == 4
        assert len(startup._startup_inits) == 4
        assert "Program(ops=" in repr(main)

    def test_mode_flags(self):
        assert tstatic.in_static_mode() and not tpaddle.in_dynamic_mode()
        tpaddle.disable_static()
        assert tstatic.in_dynamic_mode()
        tpaddle.enable_static()
        assert tpaddle.in_static_mode()

    def test_variable_is_symbolic(self):
        main, _s, x, *_ = _linreg(*PKGS["port"])
        with pytest.raises(RuntimeError):
            x.numpy()
        with pytest.raises(RuntimeError):
            x.backward()

    def test_clone_for_test_prunes_backward(self):
        for P, static, nn in PKGS.values():
            main, startup, x, y, pred, loss = _linreg(P, static, nn)
            with static.program_guard(main, startup):
                P.optimizer.Adam(learning_rate=0.1).minimize(loss)
            test = main.clone(for_test=True)
            assert test._opt is None and test._backward is None
            assert main._opt is not None


class TestExecutor:
    def test_forward_matches_jax(self):
        progs = _both(_linreg)
        outs = {}
        for k, (main, startup, x, y, pred, loss) in progs.items():
            exe = PKGS[k][1].Executor()
            exe.run(startup)
            outs[k] = [exe.run(main, feed=_feeds(s, n), fetch_list=[pred,
                                                                    loss])
                       for s, n in ((1, 5), (2, 3))]
        for jo, to in zip(outs["jax"], outs["port"]):
            for a, b in zip(jo, to):
                assert np.shape(b) == np.shape(a)
                np.testing.assert_allclose(b, a, **TOL)

    def test_fetch_by_name(self):
        main, startup, x, y, pred, loss = _linreg(*PKGS["port"])
        exe = tstatic.Executor()
        exe.run(startup)
        (r,) = exe.run(main, feed=_feeds(3, 3), fetch_list=[pred.name])
        assert r.shape == (3, 1)

    def test_training_matches_jax(self):
        progs = _both(_linreg)
        losses = {}
        for k, (main, startup, x, y, pred, loss) in progs.items():
            P, static, _ = PKGS[k]
            with static.program_guard(main, startup):
                P.optimizer.Adam(learning_rate=0.05).minimize(loss)
            exe = static.Executor()
            exe.run(startup)
            losses[k] = [float(exe.run(main, feed=_feeds(10 + i, 16),
                                       fetch_list=[loss])[0])
                         for i in range(6)]
        np.testing.assert_allclose(losses["port"], losses["jax"], **TOL)

    def test_startup_restores_params(self):
        main, startup, x, y, pred, loss = _linreg(*PKGS["port"])
        with tstatic.program_guard(main, startup):
            tpaddle.optimizer.Adam(learning_rate=0.5).minimize(loss)
        exe = tstatic.Executor()
        exe.run(startup)
        p0 = [p.detach().clone() for p in main.all_parameters()]
        exe.run(main, feed=_feeds(4, 8), fetch_list=[loss])
        assert any(not torch.equal(p, q)
                   for p, q in zip(main.all_parameters(), p0))
        exe.run(startup)
        for p, q in zip(main.all_parameters(), p0):
            assert torch.equal(p, q)

    def test_minimize_after_a_run_updates(self):
        main, startup, x, y, pred, loss = _linreg(*PKGS["port"])
        exe = tstatic.Executor()
        exe.run(startup)
        with tstatic.program_guard(main, startup):
            pairs = tstatic.append_backward(loss)
        exe.run(main, feed=_feeds(5), fetch_list=[pairs[0][1]])
        p0 = [p.detach().clone() for p in main.all_parameters()]
        with tstatic.program_guard(main, startup):
            tpaddle.optimizer.Adam(learning_rate=0.5).minimize(loss)
        exe.run(main, feed=_feeds(5), fetch_list=[loss])
        assert any(not torch.equal(p, q)
                   for p, q in zip(main.all_parameters(), p0))


class TestBackward:
    def test_param_grads_match_jax(self):
        progs = _both(_linreg)
        grads = {}
        for k, (main, startup, x, y, pred, loss) in progs.items():
            static = PKGS[k][1]
            with static.program_guard(main, startup):
                pairs = static.append_backward(loss)
            exe = static.Executor()
            exe.run(startup)
            grads[k] = exe.run(main, feed=_feeds(6, 6),
                               fetch_list=[g for _, g in pairs])
        assert len(grads["port"]) == 4
        for a, b in zip(grads["jax"], grads["port"]):
            np.testing.assert_allclose(b, a, **TOL)

    def test_gradients_wrt_data(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [None, 3], "float32")
            (gx,) = tstatic.gradients([(x * x).sum()], [x])
        xb = np.random.default_rng(7).standard_normal((4, 3)).astype(
            np.float32)
        (g,) = tstatic.Executor().run(main, feed={"x": xb}, fetch_list=[gx])
        np.testing.assert_allclose(g, 2 * xb, **TOL)

    def test_gradients_of_a_frozen_param_raise(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            w = tnn.Linear(3, 1).weight
            w.stop_gradient = True
            x = tstatic.data("x", [None, 3], "float32")
            yv = tpaddle.matmul(x, w).sum()
            with pytest.raises(ValueError):
                tstatic.gradients([yv], [w])


def _mlp_softmax(P, static, nn):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        net = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 3))
        x = static.data("x", [None, 4], "float32")
        out = P.nn.functional.softmax(net(x))
    return main, startup, x, out


def _conv_bn(P, static, nn):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("img", [None, 3, 8, 8], "float32")
        c = static.nn.conv2d(x, 4, 3, padding=1, act="relu")
        b = static.nn.batch_norm(c, is_test=True)
        out = P.nn.functional.adaptive_avg_pool2d(b, 1)
    return main, startup, x, out


def _emb(P, static, nn):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = static.data("ids", [None, 5], "int64")
        out = static.nn.embedding(ids, (10, 6))
    return main, startup, ids, out


@pytest.mark.parametrize("build,feed", [
    (_mlp_softmax, {"x": (5, 4)}),
    (_conv_bn, {"img": (2, 3, 8, 8)}),
    (_emb, {"ids": (3, 5)}),
], ids=["layers_softmax", "conv_bn", "embedding"])
def test_static_nn_matches_jax(build, feed):
    progs = _both(build)
    rng = np.random.default_rng(8)
    feeds = {n: (rng.integers(0, 10, s).astype(np.int64) if n == "ids"
                 else rng.standard_normal(s).astype(np.float32))
             for n, s in feed.items()}
    outs = {}
    for k, (main, startup, x, out) in progs.items():
        exe = PKGS[k][1].Executor()
        exe.run(startup)
        (outs[k],) = exe.run(main, feed=feeds, fetch_list=[out])
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


def test_static_layer_norm_at_an_unknown_batch():
    """``static.nn.layer_norm`` over the last axis (unit scale, zero
    shift) against the formula, at two batch sizes of one program (the
    JAX helper reshapes to its recorded batch of 1)."""
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [None, 5, 6], "float32")
        out = tstatic.nn.layer_norm(x, begin_norm_axis=2)
    exe = tstatic.Executor()
    exe.run(startup)
    for n in (2, 3):
        xb = np.random.default_rng(n).standard_normal((n, 5, 6)).astype(
            np.float32)
        (got,) = exe.run(main, feed={"x": xb}, fetch_list=[out])
        mu = xb.mean(-1, keepdims=True)
        want = (xb - mu) / np.sqrt(xb.var(-1, keepdims=True) + 1e-5)
        np.testing.assert_allclose(got, want, **TOL)


class TestControlFlow:
    def _jax_to_static(self, fn, *args):
        jpaddle.disable_static()
        try:
            return jpaddle.jit.to_static(fn)(*args)
        finally:
            jpaddle.enable_static()

    @pytest.mark.parametrize("v", [2.0, -3.0])
    def test_cond_recorded_selects_as_jax(self, v):
        def jf(x):
            return jstatic.nn.cond(x.sum() > 0, lambda: x * 2.0,
                                   lambda: x - 1.0)

        xv = np.full((3,), v, np.float32)
        want = np.asarray(self._jax_to_static(jf, jpaddle.to_tensor(xv))
                          ._value)
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [None], "float32")
            out = tstatic.nn.cond(x.sum() > 0, lambda: x * 2.0,
                                  lambda: x - 1.0)
        assert "where" in [r.op_name for r in main.ops]
        (got,) = tstatic.Executor().run(main, feed={"x": xv},
                                        fetch_list=[out])
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("i", [2, 5, 7])
    def test_switch_case_recorded_as_jax(self, i):
        def branches(P):
            return {2: lambda: P.to_tensor(10.0), 5: lambda: P.to_tensor(
                20.0)}

        want = float(self._jax_to_static(
            lambda k: jstatic.nn.switch_case(
                k, branches(jpaddle), default=lambda: jpaddle.to_tensor(
                    -1.0)), jpaddle.to_tensor(i)))
        main = tstatic.Program()
        with tstatic.program_guard(main):
            k = tstatic.data("k", [], "int64")
            out = tstatic.nn.switch_case(
                k, branches(tpaddle), default=lambda: tpaddle.to_tensor(-1.0))
        (got,) = tstatic.Executor().run(main, feed={"k": np.int64(i)},
                                        fetch_list=[out])
        assert float(got) == want

    def test_while_loop_exported_as_jax(self):
        def body(static, P):
            def f(x):
                i = x.sum() * 0.0
                _, x2 = static.nn.while_loop(
                    lambda i, x: i < 3, lambda i, x: [i + 1.0, x * 2.0],
                    [i, x])
                return x2
            return f

        xv = np.ones((2,), np.float32)
        want = np.asarray(self._jax_to_static(
            body(jstatic, jpaddle), jpaddle.to_tensor(xv))._value)
        tpaddle.disable_static()

        class Wrap(torch.nn.Module):
            def forward(self, x):
                return body(tstatic, tpaddle)(x)

        ep = torch.export.export(Wrap(), (torch.ones(2),), strict=False)
        got = ep.module()(torch.tensor(xv))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), np.full(2, 8.0), **TOL)

    def test_eager_control_flow(self):
        tpaddle.disable_static()
        t = tpaddle.to_tensor(2.0)
        assert float(tstatic.nn.cond(t > 1.0, lambda: t * 2,
                                     lambda: t / 2)) == 4.0
        out = tstatic.nn.switch_case(tpaddle.to_tensor(1), [
            lambda: tpaddle.to_tensor(10.0), lambda: tpaddle.to_tensor(20.0)])
        assert float(out) == 20.0
        i, x = tstatic.nn.while_loop(lambda i, x: i < 3,
                                     lambda i, x: [i + 1, x * 2.0],
                                     [tpaddle.to_tensor(0),
                                      tpaddle.to_tensor(1.0)])
        assert float(x) == 8.0 and int(i) == 3
        assert float(tstatic.nn.case([(t > 5.0, lambda: t * 0.0),
                                      (t > 1.0, lambda: t * 3.0)])) == 6.0


class TestInferenceModelIO:
    def test_save_load_roundtrip_matches_jax(self, tmp_path):
        progs = _both(lambda P, static, nn: _mlp_softmax(P, static, nn))
        for k, (main, startup, x, out) in progs.items():
            static = PKGS[k][1]
            exe = static.Executor()
            exe.run(startup)
            static.save_inference_model(str(tmp_path / k), [x], [out], exe,
                                        program=main)
        loaded = {k: PKGS[k][1].load_inference_model(str(tmp_path / k))
                  for k in PKGS}
        assert loaded["port"][1] == ["x"]
        for bs in (1, 6):
            xb = np.random.default_rng(bs).standard_normal((bs, 4)).astype(
                np.float32)
            res = {k: PKGS[k][1].Executor().run(loaded[k][0],
                                                feed={"x": xb})[0]
                   for k in PKGS}
            np.testing.assert_allclose(res["port"], res["jax"], **TOL)
            main, _, _, out = progs["port"]
            (direct,) = tstatic.Executor().run(main, feed={"x": xb},
                                               fetch_list=[out])
            np.testing.assert_array_equal(res["port"], direct)

    def test_shared_batch_dim_and_callable(self, tmp_path):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            a = tstatic.data("a", [None, 4], "float32")
            b = tstatic.data("b", [None, 4], "float32")
            out = (a + b * 2.0).sum(-1)
        tstatic.save_inference_model(str(tmp_path / "dual"), [a, b], [out],
                                     program=main)
        prog, feeds, fetches = tstatic.load_inference_model(
            str(tmp_path / "dual"))
        assert feeds == ["a", "b"] and len(fetches) == 1
        for n in (3, 5):
            xb = np.ones((n, 4), np.float32)
            (r,) = prog(xb, 2 * xb)
            np.testing.assert_allclose(r.numpy(), np.full(n, 20.0), **TOL)


class TestStaticAMP:
    def test_autocast_records_casts_with_live_params(self):
        main, startup = tstatic.Program(), tstatic.Program()
        with tstatic.program_guard(main, startup):
            x = tstatic.data("x", [None, 8], "float32")
            net = tnn.Linear(8, 4)
            with tpaddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                out = net(x)
        from paddle_tpu_torch.static.program import PARAM

        assert PARAM in [k for rec in main.ops for k, _ in rec.inputs]
        exe = tstatic.Executor()
        exe.run(startup)
        (r,) = exe.run(main, feed={"x": np.ones((2, 8), "f4")},
                       fetch_list=[out], return_numpy=False)
        assert r.dtype == torch.bfloat16
        with torch.no_grad():
            net.weight.zero_()
        (r2,) = exe.run(main, feed={"x": np.ones((2, 8), "f4")},
                        fetch_list=[out], return_numpy=False)
        assert not torch.equal(r2, r)


class TestCloneSemantics:
    def test_ops_on_cloned_vars_record_into_the_clone(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2, 4], "float32")
            y = x * 2.0  # noqa: F841
        n_main = len(main.ops)
        test = main.clone(for_test=True)
        with tstatic.program_guard(test):
            v = test.global_block().vars["x"]
            z = v + 1.0
            w = tstatic.data("w", [2, 4], "float32")
            q = z + w  # noqa: F841
        assert len(main.ops) == n_main
        assert len(test.ops) == n_main + 2

    @pytest.mark.parametrize("mode,scale", [("upscale_in_train", 1.0),
                                            ("downscale_in_infer", 0.75)])
    def test_clone_for_test_turns_dropout_off(self, mode, scale):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [4, 8], "float32")
            y = tpaddle.nn.functional.dropout(x, p=0.25, training=True,
                                              mode=mode)
        test = main.clone(for_test=True)
        exe = tstatic.Executor()
        xv = np.ones((4, 8), np.float32)
        (out_test,) = exe.run(test, feed={"x": xv}, fetch_list=[y])
        np.testing.assert_allclose(out_test, xv * scale, **TOL)
        (out_train,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
        assert not np.allclose(out_train, xv * scale)


def test_scope_guard():
    s = tstatic.Scope()
    with tstatic.scope_guard(s):
        assert tstatic.global_scope() is s
        s.set("k", np.ones(3, "float32"))
    assert tstatic.global_scope() is not s
    assert s.find_var("k") is not None
