"""The port's dy2static pass against the JAX package's, on the CPU.

Each function below is written once with the Paddle surface both
packages share and runs three ways on the same seeded numpy inputs:

- the JAX package's ``to_static`` (traced: its ``lax`` select and
  ``while_loop`` paths);
- the port's ``to_static`` on the CPU (concrete: plain Python, no
  graph);
- the port's converted function under ``torch.export`` (traced: the
  ``torch.where`` select and ``torch._higher_order_ops.while_loop``
  paths), the exported program then called on the inputs.

All three must agree at float32 rtol = atol = 1e-5, integers exactly:
tensor ``if`` / ``elif`` / nested ``if``, ``while``, ``for`` over a
traced ``range`` and over tensor rows, ``break`` / ``continue`` /
``return`` (concrete and traced), ``and`` / ``or`` / ``not``, casts,
``assert`` and ``print``, and the helpers of ``convert_call``. The
runtime's refusals (a multi-element predicate, diverging containers)
raise as the JAX package's do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor as JTensor  # noqa: E402
from paddle_tpu.jit import to_static as jto_static  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
from paddle_tpu_torch.jit import to_static as tto_static  # noqa: E402
from paddle_tpu_torch.jit import dy2static as td2s  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import device as tdevice

    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


# ------------------------------------------------------------ functions --


def f_if(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def f_elif(x):
    s = x.sum()
    if s > 1.0:
        out = x + 10.0
    elif s > -1.0:
        out = x
    else:
        out = x - 10.0
    return out


def f_mutates(x):
    y = x + 1.0
    if x.mean() > 0:
        y = y * 3.0
    return y


def f_nested(x):
    if x.sum() > 0:
        if x.max() > 2.0:
            y = x * 4.0
        else:
            y = x * 2.0
    else:
        y = -x
    return y


def f_while(x):
    s = x.sum()
    n = x.sum() * 0.0
    while s < 100.0:
        s = s * 2.0
        n = n + 1.0
    return s, n


def f_while_invariant(x, step):
    acc = x * 0.0
    i = x.sum() * 0.0
    while i < 4:
        acc = acc + step
        i = i + 1.0
    return acc


def f_for_range(x, n):
    acc = x * 0.0
    for i in range(n):
        acc = acc + x * 2.0
    return acc


def f_break(x):
    acc = x * 0.0
    for i in range(6):
        if acc.sum() > 5.0:
            break
        acc = acc + x
    return acc


def f_continue(x):
    acc = x * 0.0
    for i in range(5):
        if (x * i).sum() > 4.0:
            continue
        acc = acc + x * i
    return acc


def f_return_branch(x):
    if x.sum() > 0:
        return x * 3.0
    return x - 2.0


def f_return_loop(x):
    s = x.sum()
    while s < 50.0:
        if s > 20.0:
            return s * 10.0
        s = s * 2.0
    return s


def f_logical(x):
    s = x.sum()
    if s > 0 and s < 10.0:
        y = x + 1.0
    else:
        y = x - 1.0
    if not (s > 5.0) or s < -5.0:
        y = y * 2.0
    return y


def f_cast(x):
    if x.sum() > 100.0:
        pass
    i = int(x.sum() * 1.9)      # truncates toward zero
    fl = float(x.max())
    return i, fl


def f_rows(x):
    acc = x[0] * 0.0
    for row in x:
        acc = acc + row * 2.0
    return acc


def f_enumerate(x):
    acc = x[0] * 0.0
    for i, row in enumerate(x):
        acc = acc + row * i
    return acc


def _helper(x):
    if x.sum() > 0:
        y = x * 5.0
    else:
        y = x * -5.0
    return y


def f_calls_helper(x):
    if x.sum() > 100.0:
        pass
    return _helper(x) + 1.0


# name -> (function, input shapes or scalars, value sets)
CASES = {
    "if": (f_if, [(3,)]),
    "elif": (f_elif, [(2,)]),
    "mutates": (f_mutates, [(2,)]),
    "nested": (f_nested, [(2,)]),
    "while": (f_while, [(2,)]),
    "while_invariant": (f_while_invariant, [(2,), (2,)]),
    "break": (f_break, [(3,)]),
    "continue": (f_continue, [(3,)]),
    "return_branch": (f_return_branch, [(3,)]),
    "return_loop": (f_return_loop, [(2,)]),
    "logical": (f_logical, [(3,)]),
    "cast": (f_cast, [(3,)]),
    "rows": (f_rows, [(4, 3)]),
    "enumerate": (f_enumerate, [(4, 3)]),
    "calls_helper": (f_calls_helper, [(3,)]),
}
SIGNS = (1.0, -1.0, 0.3)


def _inputs(case, seed, sign):
    fn, shapes = CASES[case]
    rng = np.random.default_rng(seed)
    out = [np.abs(rng.standard_normal(s)).astype(np.float32) * sign + 0.5
           * sign for s in shapes]
    if case == "while":
        out = [np.abs(a) + 0.1 for a in out]
    if case == "return_loop":
        out = [np.abs(a) + 0.5 for a in out]
    return out


def _np(out):
    if isinstance(out, (tuple, list)):
        return [_np(o) for o in out]
    if hasattr(out, "_value"):
        return np.asarray(out._value)
    if isinstance(out, torch.Tensor):
        return torch.Tensor.numpy(out.detach().as_subclass(torch.Tensor))
    return np.asarray(out)


class _Wrap(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _exported(fn, arrays):
    conv = td2s.convert_to_static_ast(fn)
    samples = tuple(torch.tensor(a) for a in arrays)
    return torch.export.export(_Wrap(conv), samples, strict=False).module()


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_concrete_and_exported(case, sign):
    fn = CASES[case][0]
    arrays = _inputs(case, 3, sign)
    want = _np(jto_static(fn)(*[JTensor(a) for a in arrays]))
    got = _np(tto_static(fn)(*[tpaddle.to_tensor(a) for a in arrays]))
    traced = _np(_exported(fn, _inputs(case, 7, 1.0))(
        *[torch.tensor(a) for a in arrays]))
    for w, g, t in zip(np.atleast_1d(np.asarray(want, dtype=object)),
                       np.atleast_1d(np.asarray(got, dtype=object)),
                       np.atleast_1d(np.asarray(traced, dtype=object))):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **TOL)
        np.testing.assert_allclose(np.asarray(t, np.float64),
                                   np.asarray(w, np.float64), **TOL)


@pytest.mark.parametrize("n", [0, 1, 4])
def test_for_over_a_traced_range_bound(n):
    """A tensor bound: JAX lowers the loop to ``lax.while_loop``, the
    port's export to ``while_loop``; both equal Python."""
    x = np.array([1.0, 2.0], np.float32)
    want = _np(jto_static(f_for_range)(JTensor(x), JTensor(np.int32(n))))
    ep = _exported(f_for_range, [x, np.int64(3)])
    got = _np(ep(torch.tensor(x), torch.tensor(n)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, 2.0 * n * x, **TOL)


def test_concrete_flag_stays_python():
    def f(x, flag):
        if flag:
            return x * 2.0
        return x

    x = np.ones(2, np.float32)
    for flag in (True, False):
        want = _np(jto_static(f)(JTensor(x), flag))
        got = _np(tto_static(f)(tpaddle.to_tensor(x), flag))
        np.testing.assert_allclose(got, want, **TOL)


def test_multi_element_predicate_raises_as_jax():
    def f(x):
        if x > 0:
            y = x
        else:
            y = -x
        return y

    x = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="elements"):
        jto_static(f)(JTensor(x))
    with pytest.raises(ValueError, match="elements"):
        _exported(f, [x])


def test_assert_concrete_raises_and_traced_passes():
    def f(x):
        if x.sum() > 100.0:
            pass
        assert x.sum() > 0, "negative"
        return x + 1.0

    neg = np.full(2, -1.0, np.float32)
    with pytest.raises(AssertionError):
        tto_static(f)(tpaddle.to_tensor(neg))
    # traced: checked at run time by JAX's callback, not in an export
    ep = _exported(f, [np.ones(2, np.float32)])
    np.testing.assert_allclose(_np(ep(torch.tensor(neg))), neg + 1.0)


def test_print_concrete_passthrough(capsys):
    def f(x):
        print("value", 3)
        return x * 2.0

    got = tto_static(f)(tpaddle.to_tensor(np.ones(2, np.float32)))
    assert "value 3" in capsys.readouterr().out
    np.testing.assert_allclose(_np(got), [2.0, 2.0])


def test_select_keeps_containers_and_refuses_diverging_ones():
    pred = torch.tensor(True)
    Pair = __import__("collections").namedtuple("Pair", "a b")
    t = [Pair(torch.ones(2), 1), {"k": torch.zeros(2)}, td2s.UNDEFINED, 5]
    f = [Pair(torch.zeros(2), 2), {"k": torch.ones(2)}, torch.ones(1), 5]
    out = td2s._select(pred, t, f)
    assert isinstance(out[0], Pair) and torch.equal(out[0].a, torch.ones(2))
    assert int(out[0].b) == 1 and torch.equal(out[1]["k"], torch.zeros(2))
    assert torch.equal(out[2], torch.ones(1)) and out[3] == 5
    with pytest.raises(ValueError, match="containers"):
        td2s._select(pred, [(torch.ones(1),)], [(torch.ones(1), 1)])
    with pytest.raises(ValueError, match="non-tensor"):
        td2s._select(pred, ["a"], ["b"])


def test_library_modules_are_not_converted():
    import logging
    import textwrap

    assert td2s._is_library_module("logging")
    assert td2s._is_library_module("numpy.linalg")
    assert not td2s._is_library_module("")
    assert td2s.convert_call(textwrap.dedent) is textwrap.dedent
    assert td2s.convert_call(logging.getLogger) is logging.getLogger
    assert "__jst" not in vars(textwrap)


def test_converted_function_keeps_live_globals_unwritten():
    conv = td2s.convert_to_static_ast(f_calls_helper)
    assert "__jst" not in globals()
    x = tpaddle.to_tensor(np.full(3, -1.0, np.float32))
    np.testing.assert_allclose(_np(conv(x)), np.full(3, 6.0))
    assert td2s.convert_call(_helper) is not _helper
