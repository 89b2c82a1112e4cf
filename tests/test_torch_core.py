"""The port's Paddle-API core against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``paddle_tpu`` and
``paddle_tpu_torch``:

- the ``Tensor`` surface: ``to_tensor`` (values and dtypes; the port
  keeps int64 where JAX, without x64, gives int32), ``stop_gradient``
  (True by default, False turns the gradient on, where the same
  assignment on a plain ``torch.Tensor`` sets a dead attribute),
  ``backward`` / ``.grad`` / ``paddle.grad`` / ``no_grad`` and
  ``PyLayer`` gradients at rtol = 1e-6 (float32, the same arithmetic
  in another order);
- Paddle's dtype names and aliases, ``seed`` and the RNG state (both
  packages repeat their draws after a reseed; the numbers differ);
- the top-level ops at rtol = 1e-6, registered under the JAX
  package's op names;
- ``nn.Layer``: parameter and buffer names, ``state_dict`` /
  ``set_state_dict`` (missing and unexpected names), ``train`` /
  ``eval``, ``to(dtype=)`` casting floating buffers, ``clear_gradients``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.autograd import PyLayer as JPyLayer  # noqa: E402
from paddle_tpu.core import dtypes as jdt  # noqa: E402
from paddle_tpu.core.dispatch import list_ops as jlist_ops  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.autograd import PyLayer as TPyLayer  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import dtypes as tdt  # noqa: E402
from paddle_tpu_torch.core.dispatch import list_ops  # noqa: E402
from paddle_tpu_torch.core.tensor import Tensor  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

RTOL, ATOL = 1e-6, 1e-6


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(t):
    return np.asarray(t.numpy())


def _pair(seed, shape=(3, 4)):
    a = np.random.RandomState(seed).randn(*shape).astype("float32")
    return jp.to_tensor(a), tp.to_tensor(a)


@pytest.mark.parametrize("data", [
    [1.5, -2.0], [[1, 2], [3, 4]], True,
    np.arange(6, dtype="float32").reshape(2, 3),
    np.array([0.25, 0.5]),                  # float64 -> the default dtype
    np.array([1, 2], dtype="int8")],
    ids=["floats", "ints", "bool", "f32", "f64", "i8"])
def test_to_tensor_values_and_dtypes(data):
    j, t = jp.to_tensor(data), tp.to_tensor(data)
    assert isinstance(t, Tensor) and t.stop_gradient and j.stop_gradient
    np.testing.assert_array_equal(_np(t), _np(j))
    jname = np.dtype(j.dtype).name
    # JAX runs without x64: its Python ints are int32, the port's int64
    assert tdt.dtype_name(t.dtype) == ("int64" if jname == "int32"
                                       else jname)
    assert t.place == torch.device("cpu")


def test_to_tensor_dtype_argument():
    for name in ("float32", "bfloat16", "int64", "float16"):
        t = tp.to_tensor([1.0, 2.0], dtype=name)
        assert tdt.dtype_name(t.dtype) == name
    assert tdt.dtype_name(tp.to_tensor([1], dtype="int32").astype(
        "float32").dtype) == "float32"


def test_stop_gradient_turns_the_gradient_on():
    plain = torch.ones(2)
    plain.stop_gradient = False         # the trap: a dead attribute
    assert not plain.requires_grad
    t = tp.to_tensor([1.0, 2.0])
    assert t.stop_gradient and not t.requires_grad
    t.stop_gradient = False
    assert t.requires_grad and t.is_leaf and not t.stop_gradient
    t.stop_gradient = True
    assert not t.requires_grad


def test_backward_and_grad_match_jax():
    (jx, tx), (jw, tw) = _pair(0), _pair(1)
    for x in (jx, tx, jw, tw):
        x.stop_gradient = False
    outs = []
    for pkg, x, w in ((jp, jx, jw), (tp, tx, tw)):
        y = pkg.add(pkg.multiply(x, w), pkg.exp(x))
        loss = pkg.mean(pkg.sum(pkg.multiply(y, y), axis=1))
        loss.backward()
        outs.append((loss, x.grad, w.grad))
    for a, b in zip(*outs):
        assert isinstance(b, Tensor)
        np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL, atol=ATOL)
    tx.clear_grad()
    assert tx.grad is None


def test_paddle_grad_matches_jax():
    (jx, tx) = _pair(2)
    got = []
    for pkg, x in ((jp, jx), (tp, tx)):
        x.stop_gradient = False
        y = pkg.sum(pkg.multiply(pkg.tanh(x), x))
        (g,) = pkg.grad(y, x)
        got.append(_np(g))
        assert x.grad is None           # returned, not accumulated
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


def test_no_grad_and_grad_modes():
    for pkg in (jp, tp):
        x = pkg.to_tensor([1.0, 2.0])
        x.stop_gradient = False
        with pkg.no_grad():
            assert pkg.multiply(x, x).stop_gradient
        assert not pkg.multiply(x, x).stop_gradient
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
        with tp.enable_grad():
            assert tp.is_grad_enabled()


class _JCube(JPyLayer):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor
        return g * 3.0 * x * x


class _TCube(TPyLayer):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensor()         # Paddle's method form
        assert list(ctx.saved_tensor) == list(ctx.saved_tensors)
        return g * 3.0 * x * x


def test_pylayer_matches_jax():
    jx, tx = _pair(3)
    grads = []
    for cube, x in ((_JCube, jx), (_TCube, tx)):
        x.stop_gradient = False
        y = cube.apply(x)
        (y * 2.0).sum().backward()
        grads.append((_np(y), _np(x.grad)))
    assert issubclass(_TCube, torch.autograd.Function)
    for a, b in zip(*grads):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alias", sorted(jdt._ALIASES))
def test_dtype_names_match_jax(alias):
    assert tdt.dtype_name(tdt.convert_dtype(alias)) == \
        jdt.convert_dtype(alias).name
    assert tdt.is_floating_point(alias) == jdt.is_floating_point(
        jdt.convert_dtype(alias))
    assert tdt.is_integer(alias) == jdt.is_integer(jdt.convert_dtype(alias))


def test_default_dtype():
    assert tdt.dtype_name(tp.get_default_dtype()) == \
        np.dtype(jp.get_default_dtype()).name
    tp.set_default_dtype("float64")
    try:
        assert tp.to_tensor(1.5).dtype == torch.float64
        # a Layer's own dtype (float32) decides its parameters, in both
        assert tp.nn.Linear(2, 2).weight.dtype == torch.float32
    finally:
        tp.set_default_dtype("float32")
    with pytest.raises(TypeError):
        tp.set_default_dtype("int32")


def test_seed_repeats_draws_as_in_jax():
    for pkg in (jp, tp):
        pkg.seed(5)
        a = _np(pkg.rand([3, 4]))
        b = _np(pkg.randint(0, 100, [6]))
        pkg.seed(5)
        np.testing.assert_array_equal(_np(pkg.rand([3, 4])), a)
        np.testing.assert_array_equal(_np(pkg.randint(0, 100, [6])), b)
        state = pkg.get_rng_state()
        c = _np(pkg.rand([2]))
        pkg.set_rng_state(state)
        np.testing.assert_array_equal(_np(pkg.rand([2])), c)
    assert tp.rand([1000]).min() >= 0.0
    tp.seed(0)


OPS = {
    "zeros": lambda p, x, y: p.zeros([2, 3]),
    "ones_int": lambda p, x, y: p.ones([4], dtype="int32"),
    "full": lambda p, x, y: p.full([2, 2], 1.5),
    "full_int": lambda p, x, y: p.full([2, 3], 7),
    "full_bool": lambda p, x, y: p.full([3], True),
    "arange_int": lambda p, x, y: p.arange(2, 11, 3),
    "arange_float": lambda p, x, y: p.arange(0.0, 1.0, 0.25),
    "add": lambda p, x, y: p.add(x, y),
    "subtract": lambda p, x, y: p.subtract(x, y),
    "multiply": lambda p, x, y: p.multiply(x, y),
    "divide": lambda p, x, y: p.divide(x, p.add(p.abs(y), 1.0)),
    "maximum": lambda p, x, y: p.maximum(x, y),
    "sqrt_abs": lambda p, x, y: p.sqrt(p.abs(x)),
    "log_exp": lambda p, x, y: p.log(p.exp(x)),
    "matmul": lambda p, x, y: p.matmul(x, y, transpose_y=True),
    "matmul_tx": lambda p, x, y: p.matmul(x, y, transpose_x=True),
    "cast": lambda p, x, y: p.cast(p.multiply(x, 4.0), "int32"),
    "sum_all": lambda p, x, y: p.sum(x),
    "sum_axis": lambda p, x, y: p.sum(x, axis=1),
    "sum_keepdim": lambda p, x, y: p.sum(x, axis=[0, 1], keepdim=True),
    "mean_axis": lambda p, x, y: p.mean(x, axis=0),
    "mean_all_keepdim": lambda p, x, y: p.mean(x, keepdim=True),
    "mean_int": lambda p, x, y: p.mean(p.cast(p.multiply(x, 4.0), "int32"),
                                       axis=1),
    "max_axis": lambda p, x, y: p.max(x, axis=-1),
    "min_all": lambda p, x, y: p.min(y),
    "reshape": lambda p, x, y: p.reshape(x, [2, 6]),
    "flatten": lambda p, x, y: p.flatten(p.reshape(x, [3, 2, 2]), 1),
    "transpose": lambda p, x, y: p.transpose(p.reshape(x, [3, 2, 2]),
                                             [2, 0, 1]),
    "concat": lambda p, x, y: p.concat([x, y], axis=1),
    "stack": lambda p, x, y: p.stack([x, y], axis=0),
    "squeeze": lambda p, x, y: p.squeeze(p.reshape(x, [3, 1, 4]), axis=1),
    "unsqueeze": lambda p, x, y: p.unsqueeze(x, [0, 2]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_match_jax(name):
    (jx, tx), (jy, ty) = _pair(10), _pair(11)
    j, t = OPS[name](jp, jx, jy), OPS[name](tp, tx, ty)
    assert isinstance(t, Tensor)
    assert list(t.shape) == list(j.shape)
    jname = np.dtype(j.dtype).name
    assert tdt.dtype_name(t.dtype) == ("int64" if jname == "int32" and
                                       name in ("arange_int", "full_int")
                                       else jname)
    np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)


def test_registered_ops_carry_the_jax_names():
    mine = set(list_ops())
    assert {"add", "matmul", "cast", "reshape", "transpose",
            "flatten"} <= mine
    builtin = {n for n in mine if not n.startswith("my_")}
    assert builtin <= set(jlist_ops()), sorted(builtin - set(jlist_ops()))


def _layers():
    """The same small layer in both packages: a sublayer, a parameter of
    its own, a persistable float buffer, an int buffer and a
    non-persistable buffer."""
    made = []
    for pkg in (jp, tp):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(3, 2)
                self.scale = self.create_parameter(
                    [2], default_initializer=pkg.nn.initializer.Constant(2.0))
                self.register_buffer("stat", pkg.zeros([2]))
                self.register_buffer("count", pkg.zeros([1], dtype="int32"))
                self.register_buffer("scratch", pkg.ones([2]),
                                     persistable=False)

            def forward(self, x):
                return self.fc(x) * self.scale + self.stat
        made.append(Net())
    return made


def test_layer_names_and_state_dict_match_jax():
    jnet, tnet = _layers()
    assert isinstance(tnet, torch.nn.Module)
    assert [n for n, _ in tnet.named_parameters()] == \
        [n for n, _ in jnet.named_parameters()]
    assert isinstance(tnet.parameters(), list)
    assert all(isinstance(p, tp.Parameter) and not p.stop_gradient
               for p in tnet.parameters())
    assert set(tnet.state_dict()) == set(jnet.state_dict())
    assert "scratch" not in tnet.state_dict()
    arrays = {k: np.random.RandomState(1).randn(*v.shape).astype(
        np.asarray(v.numpy()).dtype) for k, v in jnet.state_dict().items()}
    arrays["extra"] = np.zeros(1, "float32")
    del arrays["fc.bias"]
    assert tnet.set_state_dict(arrays) == jnet.set_state_dict(arrays)
    x = np.random.RandomState(2).randn(4, 3).astype("float32")
    np.testing.assert_allclose(_np(tnet(tp.to_tensor(x))),
                               _np(jnet(jp.to_tensor(x))), rtol=RTOL,
                               atol=ATOL)


def test_layer_modes_cast_and_clear_gradients():
    jnet, tnet = _layers()
    for net in (jnet, tnet):
        net.eval()
        assert not net.fc.training
        net.train()
        assert net.fc.training
    for net in (jnet, tnet):
        net.to(dtype="bfloat16")
    for name in ("stat", "count", "scratch"):
        assert tdt.dtype_name(getattr(tnet, name).dtype) == \
            np.dtype(getattr(jnet, name).dtype).name
    assert tnet.fc.weight.dtype == torch.bfloat16
    assert isinstance(tnet.fc.weight, tp.Parameter)
    tnet(tp.ones([1, 3], dtype="bfloat16")).sum().backward()
    assert tnet.fc.weight.grad is not None
    tnet.clear_gradients()
    assert all(p.grad is None for p in tnet.parameters())
    assert [n for n, _ in tnet.named_sublayers(include_self=True)] == \
        [n for n, _ in jnet.named_sublayers(include_self=True)]


def test_set_device_names():
    assert tp.get_device() == "cpu"
    assert tdevice.to_torch_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tp.set_device("gpu") == torch.device("cuda")
        assert tp.get_device() == "gpu:0"
    else:
        with pytest.raises(RuntimeError):
            tp.set_device("gpu")
    assert tp.device_count() == torch.cuda.device_count()
