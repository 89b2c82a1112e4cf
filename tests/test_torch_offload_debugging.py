"""The port's ``HostOffloadAdamW``, ``amp.debugging`` and
``amp.decorate(save_dtype=...)`` against the JAX package's, on the CPU.

- ``HostOffloadAdamW`` on a bfloat16 MLP (the JAX test's net, its
  weights carried over): three steps against the JAX
  ``HostOffloadAdamW`` (losses at 1e-2 relative; on the JAX loop's own
  gradients, each parameter within one bfloat16 step: fed its own bf16
  matmuls, which round in another order than XLA's, Adam's normalized
  step would move a near-zero gradient's element by up to the learning
  rate), bit-equal to the port's own
  ``AdamW(multi_precision=True)``; the state in float32 host tensors;
  ``state_dict``'s keys equal to the JAX optimizer's, its round trip;
  ``TrainStep`` refusing the optimizer with the JAX message;
- every ``amp.debugging`` case of ``tests/test_amp_debugging.py`` on the
  port (the device-namespace case belongs to ``device/``, not ported),
  the counts held to the JAX ``check_numerics``, and a ``to_static``
  function raising at a NaN under the checker (its report giving the
  checker as the reason), running without a raise once the checker is
  off;
- ``decorate(save_dtype=...)``: the state dict's dtypes and values equal
  to the JAX package's, and read back into a float32 model.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
from paddle_tpu.amp import debugging as jdbg  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.amp import debugging as tdbg  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn import layer_state_from_jax  # noqa: E402
from paddle_tpu_torch.optimizer import (AdamW, HostOffloadAdamW,  # noqa: E402
                                        Momentum)
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture(autouse=True)
def checker_off():
    yield
    tp.set_flags({"FLAGS_check_nan_inf": False})
    jp.set_flags({"FLAGS_check_nan_inf": False})
    tdbg._prev_state.clear()


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _jax_net(seed=7):
    jp.seed(seed)
    net = jp.nn.Sequential(jp.nn.Linear(8, 16), jp.nn.GELU(),
                           jp.nn.Linear(16, 4))
    for p in net.parameters():
        p._value = p._value.astype("bfloat16")
    return net


def _port_net(jnet):
    net = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.GELU(),
                           tp.nn.Linear(16, 4))
    net.to(dtype="bfloat16")
    return layer_state_from_jax(_arrays(jnet), net)


def _data(pkg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 8)).astype("float32")
    y = rng.standard_normal((8, 4)).astype("float32")
    return (pkg.to_tensor(x).astype("bfloat16"),
            pkg.to_tensor(y).astype("bfloat16"))


def _run(pkg, F, net, opt, steps=3):
    x, y = _data(pkg)
    losses = []
    for _ in range(steps):
        loss = F.mse_loss(net(x).astype("float32"), y.astype("float32"))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    return losses


def _bf16(net):
    return [p.detach().float().numpy() for p in net.parameters()]


def test_offload_matches_jax_and_is_bit_equal_to_adamw():
    """Three steps: the port's offload and the port's AdamW bit-equal
    (losses and parameters); the port's losses within 1e-2 of the JAX
    loop's; and the update rule against the JAX offload's on the JAX
    loop's own gradients (each step, the JAX gradients handed to the
    port's optimizer): every parameter within one bfloat16 step (2^-7
    relative across a binade edge) of the JAX parameter."""
    jnet = _jax_net()
    tnet, tnet_ref, tnet_fed = (_port_net(jnet) for _ in range(3))
    kw = dict(learning_rate=0.01, weight_decay=0.01)
    tl = _run(tp, TF, tnet, HostOffloadAdamW(
        parameters=tnet.parameters(), **kw))
    rl = _run(tp, TF, tnet_ref, AdamW(parameters=tnet_ref.parameters(),
                                      multi_precision=True, **kw))
    assert tl == rl
    for t, r in zip(_bf16(tnet), _bf16(tnet_ref)):
        np.testing.assert_array_equal(t, r)
    jopt = jp.optimizer.HostOffloadAdamW(parameters=jnet.parameters(), **kw)
    fed = HostOffloadAdamW(parameters=tnet_fed.parameters(), **kw)
    x, y = _data(jp)
    jl = []
    for _ in range(3):
        loss = JF.mse_loss(jnet(x).astype("float32"), y.astype("float32"))
        loss.backward()
        jl.append(float(loss.item()))
        for tq, jq in zip(tnet_fed.parameters(), jnet.parameters()):
            tq.grad = torch.from_numpy(np.asarray(
                jq.grad.numpy(), np.float32)).to(torch.bfloat16)
        jopt.step()
        jopt.clear_grad()
        fed.step()
        for t, q in zip(_bf16(tnet_fed), jnet.parameters()):
            j = np.asarray(q._value, np.float32)
            assert (np.abs(t - j) <= 2 ** -7 * np.abs(j)).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def test_offload_state_lives_on_the_host():
    net = _port_net(_jax_net())
    opt = HostOffloadAdamW(learning_rate=0.01, parameters=net.parameters())
    _run(tp, TF, net, opt, steps=1)
    assert not opt._accumulators
    for p in net.parameters():
        assert p.dtype == torch.bfloat16
        st = opt._host[id(p)]
        assert set(st) == {"master_weight", "moment1", "moment2",
                           "beta1_pow", "beta2_pow"}
        for v in st.values():
            assert v.device.type == "cpu" and v.dtype == torch.float32
        assert st["beta1_pow"].shape == ()
    assert opt.last_step["h2d_bytes"] == opt.last_step["d2h_bytes"] == sum(
        4 * (3 * p.numel() + 2) for p in net.parameters())


def test_offload_state_dict_keys_and_round_trip():
    jnet = _jax_net()
    jkeys = set(jp.optimizer.HostOffloadAdamW(
        parameters=jnet.parameters()).state_dict())
    net = _port_net(jnet)
    opt = HostOffloadAdamW(learning_rate=0.01, parameters=net.parameters())
    assert set(opt.state_dict()) == jkeys       # made before the first step
    _run(tp, TF, net, opt, steps=2)
    sd = opt.state_dict()
    assert sd["global_step"] == 2
    twin = _port_net(jnet)
    twin.set_state_dict(net.state_dict())
    opt2 = HostOffloadAdamW(learning_rate=0.01, parameters=twin.parameters())
    opt2.set_state_dict(sd)
    assert opt2._global_step == 2
    assert _run(tp, TF, twin, opt2, 2) == _run(tp, TF, net, opt, 2)
    for a, b in zip(_bf16(twin), _bf16(net)):
        np.testing.assert_array_equal(a, b)


def test_offload_is_refused_by_train_step():
    net = _port_net(_jax_net())
    opt = HostOffloadAdamW(learning_rate=0.01, parameters=net.parameters())
    step = tp.jit.TrainStep(
        net, lambda n, x, y: TF.mse_loss(n(x).astype("float32"),
                                         y.astype("float32")), opt)
    with pytest.raises(RuntimeError, match="host memory"):
        step(*_data(tp))


# ---------------------------------------------------------- debugging ---

def test_check_numerics_counts_match_jax():
    a = np.array([1.0, np.nan, np.inf, 0.0, -np.inf, 0.0, np.nan], "f4")
    j = jdbg.check_numerics(jp.to_tensor(a),
                            debug_mode=jdbg.DebugMode.CHECK_NAN_INF)
    t = tdbg.check_numerics(tp.to_tensor(a),
                            debug_mode=tdbg.DebugMode.CHECK_NAN_INF)
    assert [int(v) for v in t] == [int(v) for v in j] == [2, 2, 2]
    assert all(isinstance(v, tp.Tensor) and v.dtype == torch.int64
               for v in t)


def test_check_numerics_abort_mode():
    t = tp.to_tensor(np.array([np.nan], "f4"))
    with pytest.raises(FloatingPointError, match="nan"):
        tdbg.check_numerics(t, "relu", "x")


def test_check_numerics_clean_tensor_no_abort():
    n_nan, n_inf, _ = tdbg.check_numerics(tp.to_tensor(np.ones(3, "f4")))
    assert int(n_nan) == 0 and int(n_inf) == 0


def test_tensor_checker_toggle_catches_div_zero():
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    try:
        x = tp.to_tensor(np.ones(1, "f4"))
        with pytest.raises(FloatingPointError):
            _ = x / tp.zeros([1])
    finally:
        tdbg.disable_tensor_checker()
    _ = tp.to_tensor(np.ones(1, "f4")) / tp.zeros([1])  # off


def test_config_enable_false_is_noop():
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=False))
    assert not tp.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    tdbg.disable_tensor_checker()


def test_disabled_enable_then_disable_restores():
    tp.set_flags({"FLAGS_check_nan_inf": True})
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=False))
    tdbg.disable_tensor_checker()
    assert tp.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]


def test_non_abort_mode_rejected():
    with pytest.raises(NotImplementedError):
        tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(
            debug_mode=tdbg.DebugMode.CHECK_NAN_INF))
    assert not tdbg._prev_state


def test_disable_restores_prior_state():
    tp.set_flags({"FLAGS_check_nan_inf": True})
    tdbg.enable_tensor_checker()
    tdbg.disable_tensor_checker()
    assert tp.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]


def test_operator_stats_stubs(capsys):
    tdbg.enable_operator_stats_collection()
    tdbg.disable_operator_stats_collection()
    assert "op dtype stats" in capsys.readouterr().out


def test_to_static_raises_at_a_nan_under_the_checker():
    """``log`` of a negative input under ``to_static`` raises under the
    checker, as the jitted JAX function does under ``jax_debug_nans``
    (its ``enable_tensor_checker`` sets that); the report gives the
    checker as why the signature runs eagerly; off, the NaN comes back."""
    a = np.array([1.0, -1.0], "f4")
    f = tp.jit.to_static(lambda x: tp.log(x) * 2.0)
    f(tp.to_tensor(np.ones(2, "f4")))          # warm, no NaN
    tdbg.enable_tensor_checker()
    try:
        with pytest.raises(FloatingPointError):
            f(tp.to_tensor(a))
        report = next(iter(f.capture_report().values()))
        assert not report["captured"]
        assert "FLAGS_check_nan_inf" in report["reason"]
    finally:
        tdbg.disable_tensor_checker()
    assert np.isnan(f(tp.to_tensor(a)).numpy()[1])
    report = next(iter(f.capture_report().values()))
    assert "FLAGS_check_nan_inf" not in report["reason"]


# --------------------------------------------------------- save_dtype ---

def _conv_net(pkg):
    return pkg.nn.Sequential(pkg.nn.Conv2D(3, 4, 3), pkg.nn.BatchNorm2D(4),
                             pkg.nn.ReLU(), pkg.nn.Flatten(),
                             pkg.nn.Linear(4 * 4 * 4, 5))


@pytest.mark.parametrize("level,dtype,save", [
    ("O2", "bfloat16", "float32"), ("O2", "bfloat16", "float16"),
    ("O1", "bfloat16", "float16")])
def test_decorate_save_dtype_matches_jax(level, dtype, save):
    jp.seed(3)
    jnet = _conv_net(jp)
    tnet = layer_state_from_jax(_arrays(jnet), _conv_net(tp))
    jm = jp.amp.decorate(jnet, level=level, dtype=dtype, save_dtype=save)
    tm, opt = tp.amp.decorate(
        tnet, Momentum(0.1, parameters=tnet.parameters()), level=level,
        dtype=dtype, save_dtype=save)
    assert tm is tnet and opt._multi_precision == (level == "O2")
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert sorted(tsd) == sorted(jsd)
    for k, v in tsd.items():
        j = np.asarray(jsd[k].numpy())
        assert str(v.dtype).split(".")[-1] == str(j.dtype), k
        np.testing.assert_array_equal(v.numpy(), j)
    # the parameters themselves keep their dtype
    assert tnet[0].weight.dtype == (torch.bfloat16 if level == "O2"
                                    else torch.float32)
    fresh = _conv_net(tp)
    fresh.set_state_dict(tsd)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), tsd[k].float().numpy().astype(v.numpy().dtype))
