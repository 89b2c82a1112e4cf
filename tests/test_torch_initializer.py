"""The port's ``nn.initializer`` against the JAX package's, on the CPU.

The port draws from torch generators and the JAX package from threefry
keys, so random initializers are compared by shape, dtype, bounds and
moments (mean within 5 standard errors of the JAX draw's, standard
deviation within 3 % of the expected one at 40,000 draws, and
reproducible under ``paddle.seed``). ``Orthogonal`` and ``Dirac`` are
held to their structure (orthonormal columns, an orthogonal centre
block and zeros elsewhere) in both packages. ``Assign``, ``Bilinear``
and ``calculate_gain`` are deterministic and equal to the JAX
package's. ``set_global_initializer`` reaches ``create_parameter`` as
in the JAX package (the given initializer first, then the default,
then the global one) and the port's ``Layer.create_parameter`` as in
Paddle (below a ``ParamAttr``'s initializer, above the layer's
default); ``ParamAttr(initializer=Normal(0.0, 0.02))`` gives a
``Linear`` that weight in both packages.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

SHAPE = [200, 200]
# the std of a standard normal truncated at +-2
TRUNC_STD = 0.8796


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved
    for p in (jp, tp):
        p.nn.initializer.set_global_initializer(None, None)


def _draw(p, init, shape=SHAPE, dtype="float32"):
    return np.asarray(init(shape, dtype).numpy() if p is tp
                      else init(shape, dtype))


RANDOM = {
    "Normal": (lambda p: p.nn.initializer.Normal(0.5, 2.0), 0.5, 2.0, None),
    "TruncatedNormal": (lambda p: p.nn.initializer.TruncatedNormal(0.0, 0.02),
                        0.0, 0.02 * TRUNC_STD, (-0.04, 0.04)),
    "KaimingNormal": (lambda p: p.nn.initializer.KaimingNormal(), 0.0,
                      math.sqrt(2.0 / SHAPE[0]), None),
    "KaimingNormal_leaky": (
        lambda p: p.nn.initializer.KaimingNormal(negative_slope=0.2,
                                                 nonlinearity="leaky_relu"),
        0.0, math.sqrt(2.0 / 1.04 / SHAPE[0]), None),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializer_moments_match_jax(name):
    make, mean, std, bounds = RANDOM[name]
    tp.seed(5)
    got = _draw(tp, make(tp))
    tp.seed(5)
    again = _draw(tp, make(tp))
    want = _draw(jp, make(jp))
    assert got.shape == want.shape == tuple(SHAPE)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, again)
    n = got.size
    assert abs(got.mean() - mean) < 5 * std / n ** 0.5
    assert abs(got.mean() - want.mean()) < 10 * std / n ** 0.5
    assert abs(got.std() - std) < 0.03 * std
    assert abs(want.std() - std) < 0.03 * std
    if bounds is not None:
        for x in (got, want):
            assert bounds[0] <= x.min() and x.max() <= bounds[1]


def test_truncated_normal_in_bfloat16():
    w = tp.nn.initializer.TruncatedNormal(1.0, 0.5)([64, 64], "bfloat16")
    assert w.dtype == torch.bfloat16
    assert 0.0 <= w.float().min() and w.float().max() <= 2.0


@pytest.mark.parametrize("shape", [[6, 4], [3, 5, 2], [4, 9]])
def test_orthogonal_structure_matches_jax(shape):
    for p in (jp, tp):
        w = _draw(p, p.nn.initializer.Orthogonal(gain=2.0), shape)
        m = w.reshape(-1, shape[-1]).astype("float64")
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, 4.0 * np.eye(len(gram)), atol=1e-5)


@pytest.mark.parametrize("shape", [[4, 4, 3, 3], [3, 2, 4], [2, 2, 3, 3, 5]])
def test_dirac_structure_matches_jax(shape):
    for p in (jp, tp):
        w = _draw(p, p.nn.initializer.Dirac(), shape).astype("float64")
        centre = tuple((k - 1) // 2 for k in shape[:-2])
        block = w[centre]
        np.testing.assert_allclose(block.T @ block if block.shape[0] >=
                                   block.shape[1] else block @ block.T,
                                   np.eye(min(block.shape)), atol=1e-5)
        rest = w.copy()
        rest[centre] = 0
        assert not rest.any()


def test_assign_bilinear_and_gain_equal_jax():
    v = np.arange(12, dtype="float32").reshape(3, 4) / 7
    np.testing.assert_array_equal(
        _draw(tp, tp.nn.initializer.Assign(v), [3, 4]),
        _draw(jp, jp.nn.initializer.Assign(v), [3, 4]))
    np.testing.assert_array_equal(
        _draw(tp, tp.nn.initializer.Assign(tp.to_tensor(v)), [4, 3]),
        _draw(jp, jp.nn.initializer.Assign(jp.to_tensor(v)), [4, 3]))
    for shape in ([2, 3, 4, 4], [1, 1, 5, 5]):
        np.testing.assert_array_equal(
            _draw(tp, tp.nn.initializer.Bilinear(), shape),
            _draw(jp, jp.nn.initializer.Bilinear(), shape))
    for args in (("tanh",), ("relu",), ("leaky_relu",), ("leaky_relu", 0.3),
                 ("selu",), ("sigmoid",), ("conv2d",)):
        assert tp.nn.initializer.calculate_gain(*args) == \
            jp.nn.initializer.calculate_gain(*args)


def test_global_initializer_reaches_create_parameter_as_in_jax():
    for p in (jp, tp):
        p.nn.initializer.set_global_initializer(
            p.nn.initializer.Constant(0.3), p.nn.initializer.Constant(0.1))
    for kw in ({}, {"is_bias": True},
               {"default_initializer": "Constant(-1.0)"},
               {"initializer": "Constant(2.0)"}):
        vals = []
        for p in (jp, tp):
            args = {k: (p.nn.initializer.Constant(float(v[9:-1]))
                        if isinstance(v, str) else v) for k, v in kw.items()}
            w = p.create_parameter([2, 3], "float32", **args)
            vals.append(np.asarray(w.detach().numpy() if p is tp
                                   else w.numpy()))
        np.testing.assert_array_equal(vals[1], vals[0])
    for p in (jp, tp):
        p.nn.initializer.set_global_initializer(None, None)
    w = tp.create_parameter([2, 3], "float32", is_bias=True)
    assert not w.detach().numpy().any()


def test_global_initializer_reaches_layers_below_param_attr():
    init = tp.nn.initializer
    init.set_global_initializer(init.TruncatedNormal(0.0, 0.02))
    tp.seed(0)
    lin = tp.nn.Linear(256, 256)
    emb = tp.nn.Embedding(512, 64)
    fixed = tp.nn.Linear(4, 4, weight_attr=tp.ParamAttr(
        initializer=init.Constant(0.5)))
    init.set_global_initializer(None)
    for w in (lin.weight, emb.weight):
        x = w.detach().numpy()
        assert np.abs(x).max() <= 0.04
        assert abs(x.std() - 0.02 * TRUNC_STD) < 0.03 * 0.02 * TRUNC_STD
    assert not lin.bias.detach().numpy().any()      # no global bias init
    assert (fixed.weight.detach().numpy() == 0.5).all()
    # without a global initializer the layers' defaults come back
    x = tp.nn.Linear(256, 256).weight.detach().numpy()
    assert abs(x.std() - math.sqrt(2.0 / 512)) < 0.03 * math.sqrt(2.0 / 512)


def test_param_attr_normal_matches_jax():
    stds = []
    for p in (jp, tp):
        lin = p.nn.Linear(256, 256, weight_attr=p.ParamAttr(
            initializer=p.nn.initializer.Normal(0.0, 0.02)))
        w = np.asarray(lin.weight.detach().numpy() if p is tp
                       else lin.weight.numpy())
        assert w.shape == (256, 256)
        stds.append(w.std())
        assert abs(w.mean()) < 5 * 0.02 / 256
    for s in stds:
        assert abs(s - 0.02) < 0.03 * 0.02
