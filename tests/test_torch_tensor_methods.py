"""Paddle's own ``Tensor`` methods on the port's ``Tensor`` against the
JAX package's, on the CPU.

One parametrised case per method the JAX package installs on its
``Tensor`` that torch does not define (``paddle_tpu_torch.core.tensor.
PADDLE_METHODS``, 52 names), from ``chip_smoke.METHOD_SWEEP`` (the table
the smoke sweeps on the card): the same numpy inputs (``op_inputs``,
seeded per case) go through ``paddle_tpu`` and ``paddle_tpu_torch``,
and the method's results (or, for the in-place ones, the tensor after
the call) are compared. Tolerances: float32 within rtol 1e-5 / atol
1e-5, integers and booleans exact (the JAX package runs without x64:
values only), eigenvalues sorted. Two methods raise in the JAX package for every
tensor (``broadcast_shape``, ``create_parameter``: the tensor lands in
a shape argument); the port's are held to the JAX top-level function
on the tensor's values. ``tpu()`` on the port goes to the card: here it
is checked to ask the device rule for ``"gpu"``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import tensor as ttensor  # noqa: E402
from chip_smoke import METHOD_SWEEP, op_inputs  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


# the JAX package's method raises for every tensor (the tensor lands in
# a shape argument): its top-level function on the tensor's values
JAX_FORMS = {
    "broadcast_shape": lambda: jp.broadcast_shape([2, 1], [1, 3]),
    "create_parameter": lambda: list(jp.create_parameter([2, 3],
                                                         "float32").shape),
}


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(a) for a in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _close(got, want, name):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), name
        for g, w in zip(got, want):
            _close(g, w, name)
        return
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "biuU":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_the_table_is_the_c2_list():
    names = sorted([*METHOD_SWEEP, "tpu"])
    assert names == sorted(ttensor.PADDLE_METHODS)
    assert len(names) == 52
    for name in names:
        assert not hasattr(torch.Tensor, name), name


@pytest.mark.parametrize("name", sorted([*METHOD_SWEEP, "tpu"]))
def test_method_matches_jax(name, monkeypatch):
    d = op_inputs(zlib.crc32(name.encode()) % 1000)
    if name == "tpu":
        asked = []

        def rule(device):
            asked.append(device)
            return torch.device("cpu")

        x = tp.to_tensor(d["f"])
        monkeypatch.setattr(ttensor, "to_torch_device", rule)
        got = x.tpu()
        assert asked == ["gpu"] and isinstance(got, tp.Tensor)
        _close(_np(got), _np(jp.to_tensor(d["f"]).tpu()), name)
        return
    want = _np(JAX_FORMS[name]() if name in JAX_FORMS
               else METHOD_SWEEP[name](jp, d))
    got = METHOD_SWEEP[name](tp, d)
    for t in (got if isinstance(got, list) else [got]):
        if isinstance(t, torch.Tensor):
            assert t.device.type == "cpu", name
    _close(_np(got), want, name)


def test_the_examples_of_the_fault():
    x = tp.to_tensor(np.arange(6, dtype="float32"))
    assert x.cast("float64").dtype == torch.float64
    np.testing.assert_array_equal(x.scale(2.0).numpy(),
                                  2 * np.arange(6, dtype="float32"))
    assert list(x.reshape_([3, 2]).shape) == [3, 2]
    assert list(x.shape) == [3, 2]
    p = tp.nn.Linear(3, 2).weight
    p.set_value(np.ones((3, 2), "float32"))
    (p * p).sum().backward()
    p.clear_gradient()
    assert p.grad is None
