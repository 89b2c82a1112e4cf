"""The port's ``quantization`` against the JAX package's, on the CPU.

The QAT / PTQ cases of ``tests/test_quant_asp.py`` (layer swaps, the
fake-quantized forward and its straight-through gradients, training,
frozen scales, calibration, the uncalibrated floor, no double wrap, the
conv wrapper) run in both packages from the same weights (crossed as
numpy through ``layer_state_from_jax``) and the port is held to the JAX
package: outputs and gradients at rtol = atol = 1e-6 (the port's
``Linear`` adds its bias in the GEMM's epilogue), every observer's scale
at 1e-7 relative (the moving average is the JAX package's float64
arithmetic, on the device). ``_qdq`` is bit-equal to the JAX package's
on the same inputs (true divisions, round half to even). The int8 tier:
``PTQ.convert_int8`` of an MLP and of a small conv net whose im2col
widths (3 x 3 x 3 = 27 and 5 x 3 x 3 = 45) are not multiples of 16, so
the codes are padded for the int8 matmul: the port's logits equal the
JAX package's bit for bit (the same codes, exact int32 sums, the same
epilogue order), weight-only within 1e-6.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu.quantization import _qdq as jqdq  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn.layer.layers import layer_state_from_jax  # noqa: E402
from paddle_tpu_torch.quantization import _qdq as tqdq  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    return np.asarray(x.numpy())


def _mlp(p):
    return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.ReLU(),
                           p.nn.Linear(16, 4))


def _pair(make, seed=0):
    """The same network in both packages: the JAX one's weights crossed
    into the port's."""
    jp.seed(seed)
    jnet = make(jp)
    tnet = make(tp)
    layer_state_from_jax({k: _np(v) for k, v in jnet.state_dict().items()},
                         tnet)
    return jnet, tnet


def _qat_cfg(p, weight=True):
    q = p.quantization
    return q.QuantConfig(
        activation=q.FakeQuanterWithAbsMaxObserver(),
        weight=q.FakeQuanterWithAbsMaxObserver() if weight else None)


def _scales(p, model):
    q = p.quantization
    return np.array([float(_np(s.scales())) for s in model.sublayers()
                     if isinstance(s, (q.FakeQuanterWithAbsMaxObserver,
                                       q.AbsMaxObserver))])


X = np.random.default_rng(1).standard_normal((4, 8)).astype("float32")


def test_qdq_bit_equal():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((64, 33)) * 3).astype("float32")
    for bits in (8, 4):
        for scale in (np.float32(2.7), np.float32(np.abs(x).max())):
            want = _np(jqdq(jp.to_tensor(x), jp.to_tensor(scale), bits))
            got = _np(tqdq(torch.tensor(x), torch.tensor(scale), bits))
            np.testing.assert_array_equal(got, want)


def test_quantize_swaps_layers():
    for p in (jp, tp):
        qmodel = p.quantization.QAT(_qat_cfg(p)).quantize(_mlp(p))
        kinds = [type(l).__name__ for l in qmodel.sublayers()]
        assert kinds.count("QuantedLinear") == 2


def test_qat_output_close_and_trainable():
    outs = {}
    for p, net in zip((jp, tp), _pair(_mlp)):
        qmodel = p.quantization.QAT(_qat_cfg(p)).quantize(net)
        x = p.to_tensor(X)
        ref = _np(net(x))
        out = qmodel(x)
        out.sum().backward()
        outs[p] = {"ref": ref, "out": _np(out), "scales": _scales(p, qmodel),
                   "grads": [_np(w.grad) for w in qmodel.parameters()]}
        assert np.abs(outs[p]["out"] - ref).max() < 0.2 + 0.05 * np.abs(
            ref).max()
    j, t = outs[jp], outs[tp]
    np.testing.assert_allclose(t["ref"], j["ref"], **TOL)
    np.testing.assert_allclose(t["out"], j["out"], **TOL)
    np.testing.assert_allclose(t["scales"], j["scales"], rtol=1e-7)
    for a, b in zip(t["grads"], j["grads"]):
        np.testing.assert_allclose(a, b, **TOL)
    assert any(np.abs(g).sum() > 0 for g in t["grads"])


def test_qat_training_converges():
    losses = {}
    for p, net in zip((jp, tp), _pair(_mlp)):
        qmodel = p.quantization.QAT(_qat_cfg(p)).quantize(net)
        opt = p.optimizer.Adam(1e-2, parameters=[
            w for w in qmodel.parameters() if not w.stop_gradient])
        rng = np.random.default_rng(0)
        w_true = rng.normal(size=(8, 4)).astype("float32")
        seen = []
        for _ in range(40):
            xb = rng.normal(size=(16, 8)).astype("float32")
            yb = (xb @ w_true).argmax(-1)
            loss = p.nn.functional.cross_entropy(qmodel(p.to_tensor(xb)),
                                                 p.to_tensor(yb))
            loss.backward()
            opt.step()
            opt.clear_grad()
            seen.append(float(loss))
        assert seen[-1] < seen[0] * 0.7
        losses[p] = seen
    np.testing.assert_allclose(losses[tp][:3], losses[jp][:3], rtol=1e-5)


def test_convert_freezes_scales():
    got = {}
    for p, net in zip((jp, tp), _pair(_mlp)):
        cfg = _qat_cfg(p, weight=False)
        qmodel = p.quantization.QAT(cfg).quantize(net)
        qmodel(p.to_tensor(X))
        converted = p.quantization.QAT(cfg).convert(qmodel)
        s0 = _scales(p, converted)
        converted(p.to_tensor(100 * X))
        assert np.array_equal(s0, _scales(p, converted))  # frozen
        got[p] = s0
    np.testing.assert_allclose(got[tp], got[jp], rtol=1e-7)


def test_ptq_flow():
    x = np.random.default_rng(3).standard_normal((32, 8)).astype("float32")
    got = {}
    for p, net in zip((jp, tp), _pair(_mlp)):
        q = p.quantization
        ptq = q.PTQ(q.QuantConfig(activation=q.AbsMaxObserver(),
                                  weight=q.AbsMaxObserver()))
        qmodel = ptq.quantize(net)
        ref = _np(net(p.to_tensor(x)))
        np.testing.assert_allclose(_np(qmodel(p.to_tensor(x))), ref,
                                   rtol=1e-5)
        converted = ptq.convert(qmodel)
        out = _np(converted(p.to_tensor(x)))
        assert not np.allclose(out, ref)
        assert np.abs(out - ref).max() < 0.1 + 0.05 * np.abs(ref).max()
        got[p] = (out, _scales(p, converted))
    np.testing.assert_allclose(got[tp][0], got[jp][0], **TOL)
    np.testing.assert_array_equal(got[tp][1], got[jp][1])


def test_ptq_uncalibrated_no_nan():
    for p in (jp, tp):
        q = p.quantization
        ptq = q.PTQ(q.QuantConfig(activation=q.AbsMaxObserver(),
                                  weight=q.AbsMaxObserver()))
        converted = ptq.convert(ptq.quantize(_mlp(p)))
        assert np.isfinite(_np(converted(p.zeros([2, 8])))).all()


def test_double_quantize_is_noop():
    for p in (jp, tp):
        cfg = _qat_cfg(p, weight=False)
        q2 = p.quantization.QAT(cfg).quantize(
            p.quantization.QAT(cfg).quantize(_mlp(p)))
        kinds = [type(l).__name__ for l in q2.sublayers()]
        assert kinds.count("QuantedLinear") == 2


def test_quanted_conv2d_no_src_sublayer():
    x = np.random.default_rng(4).standard_normal((2, 3, 8, 8)).astype("f4")
    outs = []
    for p, net in zip((jp, tp), _pair(
            lambda p: p.nn.Sequential(p.nn.Conv2D(3, 4, 3)))):
        q = p.quantization.QAT(_qat_cfg(p)).quantize(net)
        ql = q.sublayers()[0]
        assert isinstance(ql, p.quantization.QuantedConv2D)
        assert not any(isinstance(s, p.nn.Conv2D) for s in ql.sublayers())
        out = _np(q(p.to_tensor(x)))
        assert out.shape[1] == 4
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


# ---------------------------------------------------------- the int8 tier --

def test_quantize_dequantize_roundtrip():
    from paddle_tpu_torch.kernels.int8 import dequantize, quantize_absmax

    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (8, 16)).astype("f"))
    q, s = quantize_absmax(x)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(dequantize(q, s).numpy(), x.numpy(),
                               atol=float(s) * 0.51)


def test_int8_matmul_close_to_f32():
    from paddle_tpu_torch.kernels.int8 import int8_matmul, quantize_absmax

    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((4, 32)).astype("f"))
    w = torch.tensor(rng.standard_normal((32, 8)).astype("f") * 0.1)
    xq, xs = quantize_absmax(x, axis=1)
    wq, ws = quantize_absmax(w, axis=0)
    got = int8_matmul(xq, xs, wq.t().contiguous(), ws).numpy()
    np.testing.assert_allclose(got, x.numpy() @ w.numpy(), atol=0.08,
                               rtol=0.1)


def test_ptq_convert_int8_network():
    x = np.random.default_rng(7).standard_normal((8, 16)).astype("f")
    make = lambda p: p.nn.Sequential(p.nn.Linear(16, 32), p.nn.ReLU(),  # noqa: E731
                                     p.nn.Linear(32, 4))
    jnet, tnet = _pair(make)
    ref = _np(tnet(tp.to_tensor(x)))
    for weight_only in (False, True):
        outs = []
        for p, net in ((jp, jnet), (tp, tnet)):
            q = p.quantization.PTQ(p.quantization.QuantConfig()).convert_int8(
                net, weight_only=weight_only)
            outs.append(_np(q(p.to_tensor(x))))
        got = outs[1]
        assert np.abs(got - ref).max() < 0.2
        assert np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-6) < 0.1
        if weight_only:
            np.testing.assert_allclose(got, outs[0], **TOL)
        else:
            np.testing.assert_array_equal(got, outs[0])


class _ConvNet:
    """Two convolutions (im2col widths 27 and 45, not multiples of 16),
    a pool and a linear head, written against either package."""

    @staticmethod
    def make(p):
        nn = p.nn
        return nn.Sequential(nn.Conv2D(3, 5, 3, padding=1), nn.ReLU(),
                             nn.Conv2D(5, 6, 3, stride=2, padding=1),
                             nn.ReLU(), nn.MaxPool2D(2), nn.Flatten(),
                             nn.Linear(6 * 2 * 2, 10))


def test_convert_int8_conv_net_bit_equal():
    x = np.random.default_rng(8).standard_normal((3, 3, 8, 8)).astype("f")
    jnet, tnet = _pair(_ConvNet.make, seed=3)
    outs, kinds = [], []
    for p, net in ((jp, jnet), (tp, tnet)):
        q = p.quantization.PTQ(p.quantization.QuantConfig()).convert_int8(
            net)
        kinds.append([type(s).__name__ for s in q.sublayers()])
        outs.append(_np(q(p.to_tensor(x))))
    assert kinds[0] == kinds[1]
    assert kinds[1].count("_Int8Conv2DLayer") == 2
    np.testing.assert_array_equal(outs[1], outs[0])
    ref = _np(tnet(tp.to_tensor(x)))
    assert np.abs(outs[1] - ref).max() < 0.05 * np.abs(ref).max() + 0.05


def test_convert_int8_counts_its_kernel_launches(monkeypatch):
    """Every converted conv and linear goes through the int8 matmul
    wrapper (the kernel on the card, its plain version here)."""
    from paddle_tpu_torch.kernels import int8 as ti8

    calls = []
    real = ti8.int8_matmul
    monkeypatch.setattr(ti8, "int8_matmul",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    jp.seed(0)
    net = _ConvNet.make(tp)
    q = tp.quantization.PTQ(tp.quantization.QuantConfig()).convert_int8(net)
    q(tp.to_tensor(np.ones((2, 3, 8, 8), "f")))
    assert [s[1] for s in calls] == [32, 48, 32]   # K padded to 16s
    assert copy.deepcopy(q) is not q
