"""The port's ``onnx.export`` against the JAX package's, on the CPU.

The cases of ``tests/test_onnx_export.py``: each model is built in both
packages from the same weights (crossed as numpy through
``layer_state_from_jax``), both are exported, and the port's file is run
through that test file's own ONNX evaluator (``_run_onnx``) and held to
the JAX package's forward, and to the JAX file run the same way, at
that file's tolerances. The refusals name the op (sort; a transposed
conv), and an export after a refusal works: the JAX exporter leaks its
refused trace into the next export in the same process, the port keeps
nothing between calls. ``chip_tools/onnx_eval.py`` (the numpy evaluator
the card's smoke uses where JAX is absent) agrees with
``_run_onnx`` on every file, and the ``jit.save`` artifact is written at
``path`` as well. ResNet and MobileNet-v1 are refused as the JAX
exporter refuses them (average pooling; a grouped conv).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn.layer.layers import layer_state_from_jax  # noqa: E402
from test_onnx_export import _run_onnx  # noqa: E402
from chip_tools import onnx_eval  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    return np.asarray(x.numpy())


def _pair(make, seed=0):
    jp.seed(seed)
    jnet, tnet = make(jp), make(tp)
    if list(jnet.state_dict()):
        layer_state_from_jax(
            {k: _np(v) for k, v in jnet.state_dict().items()}, tnet)
    jnet.eval()
    tnet.eval()
    return jnet, tnet


def _exported(tmp_path, make, specs, inputs, tol, seed=0):
    """Both packages' exports of ``make``: the port's file evaluated and
    held to the JAX forward and the JAX file's evaluation."""
    jnet, tnet = _pair(make, seed)
    outs = []
    for p, net in ((jp, jnet), (tp, tnet)):
        path = p.onnx.export(net, str(tmp_path / p.__name__),
                             input_spec=specs)
        blob = open(path, "rb").read()
        outs.append(_run_onnx(blob, inputs))
    (jfile,), (tfile,) = outs
    ref = _np(jnet(*[jp.to_tensor(x) for x in inputs]))
    np.testing.assert_allclose(tfile, ref, **tol)
    np.testing.assert_allclose(tfile, jfile, **tol)
    (rt,) = onnx_eval.run(blob, inputs)
    np.testing.assert_allclose(rt, tfile, **tol)
    return blob


def _mlp(p):
    class MLP(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = p.nn.Linear(8, 16)
            self.fc2 = p.nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(p.nn.functional.relu(self.fc1(x)))
    return MLP()


def test_mlp_roundtrip(tmp_path):
    x = np.random.RandomState(0).randn(2, 8).astype("float32")
    blob = _exported(tmp_path, _mlp, [((2, 8), "float32")], [x],
                     dict(rtol=1e-5, atol=1e-5))
    mod = tp.onnx._proto.decode_model(blob)
    assert mod["opset"] == 13 and mod["producer"] == "paddle-tpu"
    assert (tmp_path / "paddle_tpu_torch.pdmodel").exists()


def test_lenet_conv_pool_roundtrip(tmp_path):
    x = np.random.RandomState(1).randn(2, 1, 28, 28).astype("float32")
    _exported(tmp_path, lambda p: p.vision.models.LeNet(),
              [((2, 1, 28, 28), "float32")], [x],
              dict(rtol=1e-4, atol=1e-4), seed=1)


def _zoo(p):
    F = p.nn.functional

    class Zoo(p.nn.Layer):
        def forward(self, x):
            a = p.tanh(x) + F.sigmoid(x) * p.exp(-p.abs(x))
            b = F.gelu(x)
            c = p.sqrt(p.abs(x) + 1.0)
            return (a + b) / c
    return Zoo()


def test_activation_zoo_roundtrip(tmp_path):
    x = np.random.RandomState(2).randn(3, 5).astype("float32")
    _exported(tmp_path, _zoo, [((3, 5), "float32")], [x],
              dict(rtol=1e-4, atol=1e-5))


def _sorty(p):
    class Sorty(p.nn.Layer):
        def forward(self, x):
            return p.sort(x)
    return Sorty()


def test_unsupported_op_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="unsupported op 'aten.sort"):
        tp.onnx.export(_sorty(tp), str(tmp_path / "s"),
                       input_spec=[((4,), "float32")])


def test_rem_exports_floor_mod_semantics(tmp_path):
    def make(p):
        class Moddy(p.nn.Layer):
            def forward(self, x, y):
                return p.mod(x, y)
        return Moddy()
    x = np.array([-7.0, 7.0, -7.0], np.float32)
    y = np.array([3.0, -3.0, -3.0], np.float32)
    _exported(tmp_path, make, [((3,), "float32"), ((3,), "float32")],
              [x, y], dict(rtol=1e-6, atol=0))


def test_transposed_conv_raises_not_silent(tmp_path):
    net = tp.nn.Conv2DTranspose(2, 3, 3, stride=2)
    net.eval()
    with pytest.raises(NotImplementedError, match="transposed"):
        tp.onnx.export(net, str(tmp_path / "t"),
                       input_spec=[((1, 2, 8, 8), "float32")])


def test_export_after_a_refusal_works(tmp_path):
    for name, kw in (("resnet18", {}), ("mobilenet_v1", {"scale": 0.25})):
        net = getattr(tp.vision.models, name)(num_classes=10, **kw)
        net.eval()
        with pytest.raises(NotImplementedError,
                           match="adaptive_avg_pool2d|groups=1"):
            tp.onnx.export(net, str(tmp_path / name),
                           input_spec=[((1, 3, 32, 32), "float32")])
    with pytest.raises(NotImplementedError):
        tp.onnx.export(_sorty(tp), str(tmp_path / "s"),
                       input_spec=[((4,), "float32")])
    x = np.random.RandomState(1).randn(2, 1, 28, 28).astype("float32")
    _exported(tmp_path, lambda p: p.vision.models.LeNet(),
              [((2, 1, 28, 28), "float32")], [x],
              dict(rtol=1e-4, atol=1e-4), seed=1)
