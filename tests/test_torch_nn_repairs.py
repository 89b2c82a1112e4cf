"""``Embedding(padding_idx=)``, ``layer_norm`` / ``LayerNorm`` with
Paddle's arguments and the reductions at ``axis=[]``: the port against
the JAX package on the CPU.

The same numpy inputs, made from a seed, go through ``paddle_tpu`` and
``paddle_tpu_torch``; outputs and gradients agree at rtol = atol = 1e-6
(float32, the same arithmetic in another order), exactly where the
answer is a copy or a zero:

- ``Embedding``: the ids equal to ``padding_idx`` look up exact zeros
  whatever the table holds (here a carried table whose padding row is
  not zero), and the gradient to that row is zero; the constructor zeros
  the row; a negative ``padding_idx`` counts from the end;
- ``nn.functional.layer_norm`` over one and two trailing axes, with and
  without weight and bias; ``LayerNorm([3, 4])`` and
  ``LayerNorm(4, weight_attr=False, bias_attr=False)`` (no parameters);
  ``gelu`` takes ``name``;
- ``sum``, ``mean``, ``max`` and ``min`` at ``axis=[]`` and ``()``
  (nothing reduced) and ``None`` (every axis), with ``keepdim`` either
  way, on float32 and int32 inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
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


def _carry(jlayer, tlayer, arrays):
    """The same parameter values in both layers."""
    jlayer.set_state_dict(arrays)
    tlayer.set_state_dict({k: torch.from_numpy(v) for k, v in
                           arrays.items()})


@pytest.mark.parametrize("padding_idx", [2, -1])
def test_embedding_padding_ids_look_up_zeros(padding_idx):
    rng = np.random.RandomState(0)
    table = rng.randn(6, 5).astype("float32")      # row k is not zero
    ids = np.array([[0, 2, 5, 2], [5, 1, 3, 0]], dtype="int64")
    grads = rng.randn(2, 4, 5).astype("float32")
    got = []
    for pkg in (jp, tp):
        emb = pkg.nn.Embedding(6, 5, padding_idx=padding_idx)
        k = padding_idx % 6
        assert float(np.abs(_np(emb.weight)[k]).max()) == 0.0   # at init
        if pkg is jp:
            emb.set_state_dict({"weight": table})
        else:
            emb.set_state_dict({"weight": torch.from_numpy(table)})
        out = emb(pkg.to_tensor(ids))
        loss = pkg.sum(pkg.multiply(out, pkg.to_tensor(grads)))
        loss.backward()
        got.append((_np(out), _np(emb.weight.grad)))
    (jo, jg), (to, tg) = got
    k = padding_idx % 6
    assert (to[ids == k] == 0).all() and (jo[ids == k] == 0).all()
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to[ids != k], table[ids[ids != k]])
    assert (tg[k] == 0).all()
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_embedding_reset_parameters_keeps_the_padding_row_zero():
    emb = tp.nn.Embedding(7, 3, padding_idx=4)
    emb.reset_parameters(torch.Generator().manual_seed(1))
    w = emb.weight.detach().numpy()
    assert (w[4] == 0).all() and (np.abs(np.delete(w, 4, 0)) > 0).any()


@pytest.mark.parametrize("shape", [[4], [3, 4]], ids=["1-axis", "2-axes"])
@pytest.mark.parametrize("affine", [True, False], ids=["wb", "plain"])
def test_layer_norm_functional_matches_jax(shape, affine):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(2, 3, 4).astype("float32") * 3 + 1
    w = rng.randn(*shape).astype("float32")
    b = rng.randn(*shape).astype("float32")
    got = []
    for pkg in (jp, tp):
        args = ((pkg.to_tensor(w), pkg.to_tensor(b)) if affine else ())
        out = pkg.nn.functional.layer_norm(pkg.to_tensor(x), shape, *args,
                                           epsilon=1e-5, name=None)
        got.append(_np(out))
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)
    if not affine:      # normalized over exactly the trailing axes
        axes = tuple(range(3 - len(shape), 3))
        np.testing.assert_allclose(got[1].mean(axis=axes), 0, atol=1e-6)


def test_layer_norm_layer_two_axes_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 4).astype("float32")
    arrays = {"weight": rng.randn(3, 4).astype("float32"),
              "bias": rng.randn(3, 4).astype("float32")}
    jln, tln = jp.nn.LayerNorm([3, 4]), tp.nn.LayerNorm([3, 4])
    assert list(tln.weight.shape) == [3, 4]
    _carry(jln, tln, arrays)
    got = []
    for pkg, ln in ((jp, jln), (tp, tln)):
        xt = pkg.to_tensor(x)
        xt.stop_gradient = False
        out = ln(xt)
        pkg.sum(pkg.multiply(out, out)).backward()
        got.append((_np(out), _np(xt.grad), _np(ln.weight.grad)))
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_layer_norm_layer_without_parameters():
    x = np.random.RandomState(6).randn(3, 4).astype("float32")
    jln = jp.nn.LayerNorm(4, weight_attr=False, bias_attr=False)
    tln = tp.nn.LayerNorm(4, weight_attr=False, bias_attr=False)
    assert tln.weight is None and tln.bias is None
    assert list(tln.parameters()) == [] == list(jln.parameters())
    np.testing.assert_allclose(_np(tln(tp.to_tensor(x))),
                               _np(jln(jp.to_tensor(x))), rtol=RTOL,
                               atol=ATOL)


def test_gelu_takes_name():
    x = np.linspace(-3, 3, 7).astype("float32")
    got = [_np(pkg.nn.functional.gelu(pkg.to_tensor(x), approximate=True,
                                      name="g")) for pkg in (jp, tp)]
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("axis", [[], (), None], ids=["list", "tuple",
                                                       "none"])
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_reductions_at_an_empty_axis_list(op, axis, keepdim, dtype):
    x = (np.random.RandomState(7).randn(3, 4) * 5).astype(dtype)
    j = getattr(jp, op)(jp.to_tensor(x), axis=axis, keepdim=keepdim)
    t = getattr(tp, op)(tp.to_tensor(x), axis=axis, keepdim=keepdim)
    assert list(t.shape) == list(j.shape)
    np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)
    if axis is not None:           # nothing reduced: x itself
        assert list(t.shape) == [3, 4]
        np.testing.assert_array_equal(_np(t), x)
    if op == "mean":               # float32 for integer inputs too
        assert t.dtype == torch.float32
