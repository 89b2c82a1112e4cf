"""The port's ``jit.to_static``, ``TrainStep`` and ``jit.save`` /
``jit.load`` against the JAX package's, on the CPU.

The same weights (JAX's, carried across as arrays) and the same seeded
numpy inputs go through both packages:

- ``to_static`` of a layer and of a function; a parameter updated in
  place is seen by the next call (``tests/test_jit.py:28``); on the CPU
  every signature runs eagerly and ``capture_report`` says so;
- ``TrainStep`` with a ``loss_fn`` that branches on a tensor (the
  dy2static pass, as JAX's step applies it);
- a 2-layer narrow GPT: ``to_static`` logits, and ``jit.save`` /
  ``jit.load`` with ``InputSpec([None, S])`` (one artifact serves two
  batch sizes), the loaded layer's ``state_dict`` names the JAX
  package's, its logits and the gradients of a loss through it.

float32 at rtol = atol = 1e-5; the GPT at 1e-4, as in
``tests/test_torch_gpt.py``: the port runs the flash kernels' plain
version, the JAX package its reference attention, two float32 orders of
summation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpaddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.static import InputSpec as JInputSpec  # noqa: E402
from paddle_tpu.text import gpt as jgpt  # noqa: E402
import paddle_tpu_torch as tpaddle  # noqa: E402
import paddle_tpu_torch.nn as tnn  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.jit import TrainStep as TTrainStep  # noqa: E402
from paddle_tpu_torch.nn.layer.layers import layer_state_from_jax  # noqa: E402
from paddle_tpu_torch.static import InputSpec as TInputSpec  # noqa: E402
from paddle_tpu_torch.text import gpt as tgpt  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
GPT = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=128, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
S = 64


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import device as tdevice

    saved = tdevice._CURRENT[0]
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _mlps():
    jpaddle.seed(11)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    layer_state_from_jax({n: np.asarray(p._value)
                          for n, p in jm.named_parameters()}, tm)
    return jm, tm


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_to_static_layer_matches_jax_and_reports_cpu():
    jm, tm = _mlps()
    x = _x((3, 8))
    want = np.asarray(jpaddle.jit.to_static(jm)(jpaddle.to_tensor(x))._value)
    tpaddle.jit.to_static(tm)
    for _ in range(3):
        got = tm(tpaddle.to_tensor(x))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    (rep,) = tm.forward.capture_report().values()
    assert rep == {"captured": False, "reason": "runs on the CPU",
                   "calls": 3, "captures": 0, "replays": 0}
    assert not got.requires_grad          # no_grad, as the JAX jit


def test_to_static_sees_param_updates():
    jm, tm = _mlps()
    x = _x((3, 8))
    js, ts = jpaddle.jit.to_static(jm), tpaddle.jit.to_static(tm)
    first = ts(tpaddle.to_tensor(x)).numpy()
    jm[0].weight.set_value(np.zeros((8, 16), np.float32))
    with torch.no_grad():
        tm[0].weight.zero_()
    want = np.asarray(js(jpaddle.to_tensor(x))._value)
    got = ts(tpaddle.to_tensor(x)).numpy()
    assert not np.allclose(first, got)
    np.testing.assert_allclose(got, want, **TOL)


def test_to_static_function_and_static_flags():
    a, b = _x((2, 3), 1), _x((3, 2), 2)

    def f(a, b, plus):
        if plus:
            return tpaddle.matmul(a, b) + 1.0
        return tpaddle.matmul(a, b)

    def jf(a, b, plus):
        if plus:
            return jpaddle.matmul(a, b) + 1.0
        return jpaddle.matmul(a, b)

    sf, jsf = tpaddle.jit.to_static(f), jpaddle.jit.to_static(jf)
    for plus in (True, False):
        want = np.asarray(jsf(jpaddle.to_tensor(a), jpaddle.to_tensor(b),
                              plus)._value)
        got = sf(tpaddle.to_tensor(a), tpaddle.to_tensor(b), plus)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert len(sf.capture_report()) == 2     # a signature per flag


def test_train_step_loss_fn_goes_through_dy2static():
    """The loss branches on a tensor; both steps convert it."""
    jm, tm = _mlps()

    def loss_fn(net, x, y):
        out = net(x)
        if out.mean() > 0:
            loss = ((out - y) ** 2).mean() * 2.0
        else:
            loss = ((out - y) ** 2).mean()
        return loss

    jstep = JTrainStep(jm, loss_fn, jpaddle.optimizer.Adam(
        learning_rate=0.01, parameters=jm.parameters()))
    tstep = TTrainStep(tm, loss_fn, tpaddle.optimizer.Adam(
        learning_rate=0.01, parameters=tm.parameters()))
    assert tstep.loss_fn is not loss_fn
    for i in range(3):
        x, y = _x((4, 8), 10 + i), _x((4, 4), 20 + i)
        jl = float(jstep(jpaddle.to_tensor(x), jpaddle.to_tensor(y)).item())
        tl = float(tstep(tpaddle.to_tensor(x), tpaddle.to_tensor(y)).item())
        np.testing.assert_allclose(tl, jl, **TOL)


def _gpts(seed=0):
    jpaddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**GPT), device="cpu")
    tgpt.gpt_params_from_jax({n: np.asarray(p._value)
                              for n, p in jm.named_parameters()}, tm)
    jm.eval()
    return jm, tm.eval()


def _ids(b, seed=3):
    return np.random.default_rng(seed).integers(
        0, GPT["vocab_size"], (b, S)).astype(np.int64)


def test_gpt_to_static_matches_jax():
    jm, tm = _gpts()
    ids = _ids(2)
    want = np.asarray(jpaddle.jit.to_static(jm)(
        jpaddle.to_tensor(ids))._value)
    tpaddle.jit.to_static(tm)
    got = tm(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, **GPT_TOL)


def test_jit_save_requires_input_spec(tmp_path):
    _, tm = _gpts()
    with pytest.raises(ValueError, match="input_spec"):
        tpaddle.jit.save(tm, str(tmp_path / "m"))


def test_gpt_save_load_matches_jax_with_a_shared_batch_dim(tmp_path):
    jm, tm = _gpts()
    jpaddle.jit.save(jm, str(tmp_path / "jax"),
                     input_spec=[JInputSpec([None, S], "int64")])
    tpaddle.jit.save(tm, str(tmp_path / "port"),
                     input_spec=[TInputSpec([None, S], "int64")])
    jl = jpaddle.jit.load(str(tmp_path / "jax"))
    tl = tpaddle.jit.load(str(tmp_path / "port"))
    assert list(tl.state_dict()) == list(jl.state_dict())
    for b in (2, 3):
        ids = _ids(b, seed=b)
        want = np.asarray(jl(jpaddle.to_tensor(ids))._value)
        got = tl(torch.tensor(ids))
        np.testing.assert_allclose(got.detach().numpy(), want, **GPT_TOL)
        np.testing.assert_allclose(
            got.detach().numpy(), tm(torch.tensor(ids)).detach().numpy(),
            rtol=0, atol=0)


def test_loaded_gpt_is_differentiable_as_jax(tmp_path):
    jm, tm = _gpts()
    jpaddle.jit.save(jm, str(tmp_path / "jax"),
                     input_spec=[JInputSpec([None, S], "int64")])
    tpaddle.jit.save(tm, str(tmp_path / "port"),
                     input_spec=[TInputSpec([None, S], "int64")])
    jl = jpaddle.jit.load(str(tmp_path / "jax"))
    tl = tpaddle.jit.load(str(tmp_path / "port"))
    ids = _ids(2, seed=9)
    labels = np.roll(ids, -1, axis=1)
    jlogits = jl(jpaddle.to_tensor(ids))
    JF.cross_entropy(jlogits.reshape([-1, GPT["vocab_size"]]),
                     jpaddle.to_tensor(labels.reshape(-1))).backward()
    tlogits = tl(torch.tensor(ids))
    TF.cross_entropy(tlogits.reshape(-1, GPT["vocab_size"]),
                     torch.tensor(labels.reshape(-1))).backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jl.named_parameters()}
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], **GPT_TOL,
                                   err_msg=name)
