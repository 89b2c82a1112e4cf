"""The port's vision layers and ResNet against the JAX package's, on the CPU.

The same seeded numpy inputs and the same weights (the JAX layers'
``state_dict`` carried over with ``layer_state_from_jax``) go through
both packages, in float32:

- ``Conv2D`` (stride, padding, dilation, groups, bias), ``MaxPool2D``
  (``-inf`` padding, ceil mode), ``AdaptiveAvgPool2D`` (divisible and
  not), ``Linear``, ``ReLU``/``Flatten``/``Sequential`` and
  ``cross_entropy``: outputs and input/weight gradients at rtol = atol
  = 1e-5 (float32 convolutions sum in another order);
- ``BatchNorm2D`` in training (two steps, running statistics with
  Paddle's momentum and the unbiased variance), in eval and with
  ``use_global_stats``, at 1e-5; its buffers keep the dtype the JAX
  package gives them under AMP O2;
- one ``BottleneckBlock`` with its downsample branch, forward and
  every gradient at 1e-5 of each tensor's largest value;
- ``Momentum`` (plain, Nesterov, weight decay, bf16 with float32
  masters) against ``paddle_tpu.optimizer.Momentum`` at rtol = 1e-6;
- ``resnet18`` (10 classes; Paddle's initializer distributions drawn
  with numpy for speed) at 64 x 64, batch 2, three ``TrainStep``
  steps of ``Momentum(1e-3, 0.9)`` against JAX's ``TrainStep``: losses at
  1e-4 relative, parameters at 1e-5 absolute, BatchNorm buffers within
  1e-4 of each buffer's largest value (measured: losses ~1e-6 relative,
  parameters ~2.4e-7). At 32 x 32 the last stage is 1 x 1, so its
  BatchNorm normalises two values per channel and a 2e-5 float32
  difference upstream becomes 2e-2 there (JAX's own eager and compiled
  runs disagree by 5e-4 in the first loss); with lr >= 1e-2 batch-2
  BatchNorm gradients grow the same noise into the parameters (JAX's
  eager and compiled runs then disagree by 3e-3), while the port's
  first gradients agree with JAX's at 2e-5 of each tensor's maximum;
- AMP O2 bfloat16: the running statistics are bfloat16 in both, a
  small conv net's losses agree at 2e-2 (bf16 activations).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu.nn.initializer as jinit  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.vision.models import resnet as jresnet  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.vision.models import (layer_state_from_jax,  # noqa: E402
                                            resnet as tresnet)
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    return layer_state_from_jax(_arrays(jlayer), tlayer)


def _input(shape, seed, grad=True):
    a = np.random.RandomState(seed).randn(*shape).astype("float32")
    j, t = jp.to_tensor(a), tp.to_tensor(a)
    j.stop_gradient = t.stop_gradient = not grad
    return j, t


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=tol,
                               atol=tol)


def _forward_backward(jlayer, tlayer, shape, seed=0):
    jx, tx = _input(shape, seed)
    jy, ty = jlayer(jx), tlayer(tx)
    _close(ty, jy)
    w = np.random.RandomState(seed + 1).randn(*ty.shape).astype("float32")
    (jy * jp.to_tensor(w)).sum().backward()
    (ty * tp.to_tensor(w)).sum().backward()
    _close(tx.grad, jx.grad)
    jparams = dict(jlayer.named_parameters())
    for name, p in tlayer.named_parameters():
        _close(p.grad, jparams[name].grad)


@pytest.mark.parametrize("cfg", [
    dict(in_channels=3, out_channels=8, kernel_size=3),
    dict(in_channels=4, out_channels=6, kernel_size=3, stride=2, padding=1),
    dict(in_channels=4, out_channels=4, kernel_size=(3, 1), padding=[1, 0],
         bias_attr=False),
    dict(in_channels=6, out_channels=4, kernel_size=3, groups=2, dilation=2,
         padding=2),
    dict(in_channels=3, out_channels=5, kernel_size=7, stride=2, padding=3,
         bias_attr=False),
    dict(in_channels=2, out_channels=3, kernel_size=3, stride=2,
         padding="SAME"),
    dict(in_channels=2, out_channels=3, kernel_size=4, stride=2,
         padding="SAME"),
    dict(in_channels=2, out_channels=3, kernel_size=(2, 3), stride=(1, 3),
         dilation=2, padding="SAME"),
    dict(in_channels=2, out_channels=3, kernel_size=3, stride=2,
         padding="VALID")],
    ids=["plain", "stride_pad", "rect", "groups_dilation", "stem",
         "same_stride2", "same_even_kernel", "same_dilated", "valid"])
def test_conv2d_matches_jax(cfg):
    jconv, tconv = jp.nn.Conv2D(**cfg), tp.nn.Conv2D(**cfg)
    assert [n for n, _ in tconv.named_parameters()] == \
        [n for n, _ in jconv.named_parameters()]
    _carry(jconv, tconv)
    _forward_backward(jconv, tconv, (2, cfg["in_channels"], 11, 9))


def test_conv2d_uses_paddles_initializers():
    tp.seed(1)
    conv = tp.nn.Conv2D(16, 32, 3)
    fan_in = 16 * 9
    w, b = conv.weight.detach(), conv.bias.detach()
    assert w.abs().max() <= np.sqrt(6.0 / fan_in)
    assert w.abs().max() > 0.9 * np.sqrt(6.0 / fan_in)   # not a^2=5's bound
    assert b.abs().max() <= 1.0 / np.sqrt(fan_in)
    tp.seed(1)
    np.testing.assert_array_equal(tp.nn.Conv2D(16, 32, 3).weight.numpy(),
                                  w.numpy())
    lin = tp.nn.Linear(64, 32)
    assert abs(float(lin.weight.detach().std()) - np.sqrt(2.0 / 96)) < 0.02
    assert float(lin.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["train", "eval", "global_stats"])
def test_batch_norm_matches_jax(kind):
    kw = {"use_global_stats": True} if kind == "global_stats" else {}
    jbn, tbn = jp.nn.BatchNorm2D(5, **kw), tp.nn.BatchNorm2D(5, **kw)
    rng = np.random.RandomState(3)
    arrays = _arrays(jbn)
    arrays["_mean"] = rng.randn(5).astype("float32")
    arrays["_variance"] = rng.rand(5).astype("float32") + 0.5
    arrays["weight"] = rng.randn(5).astype("float32")
    arrays["bias"] = rng.randn(5).astype("float32")
    jbn.set_state_dict(arrays)
    layer_state_from_jax(arrays, tbn)
    assert set(tbn.state_dict()) == {"weight", "bias", "_mean", "_variance"}
    if kind == "eval":
        jbn.eval()
        tbn.eval()
    for seed in (4, 5):
        _forward_backward(jbn, tbn, (3, 5, 4, 6), seed)
    for name in ("_mean", "_variance"):
        _close(getattr(tbn, name), getattr(jbn, name))
    if kind == "train":     # the statistics moved, by Paddle's momentum
        assert not np.allclose(tbn._mean.numpy(), arrays["_mean"])


@pytest.mark.parametrize("cfg", [dict(kernel_size=3, stride=2, padding=1),
                                 dict(kernel_size=2),
                                 dict(kernel_size=3, stride=2, ceil_mode=True),
                                 dict(kernel_size=3, stride=2, padding="SAME"),
                                 dict(kernel_size=3, stride=2,
                                      padding="VALID"),
                                 dict(kernel_size=2, stride=3, padding="SAME")],
                         ids=["resnet_stem", "k2", "ceil", "same", "valid",
                              "same_k2_s3"])
@pytest.mark.parametrize("shape", [(2, 3, 9, 8), (2, 3, 10, 7)])
def test_max_pool2d_matches_jax(cfg, shape):
    _forward_backward(jp.nn.MaxPool2D(**cfg), tp.nn.MaxPool2D(**cfg), shape)


@pytest.mark.parametrize("padding,want", [("VALID", [2, 3, 4, 3]),
                                          ("SAME", [2, 3, 5, 4])])
def test_max_pool2d_string_padding_shapes(padding, want):
    """The functional form on ``[2, 3, 10, 7]``, k 3, s 2: the JAX
    package's shapes and values ("SAME" pads with -inf)."""
    jx, tx = _input((2, 3, 10, 7), 6, grad=False)
    j = JF.max_pool2d(jx, 3, 2, padding)
    t = TF.max_pool2d(tx, 3, 2, padding)
    assert list(t.shape) == list(j.shape) == want
    _close(t, j)


def test_conv2d_same_stride_two_shape():
    """``[1, 2, 8, 8]``, k 3, s 2, "SAME": ``[1, 3, 4, 4]`` in both."""
    jconv = jp.nn.Conv2D(2, 3, 3, stride=2, padding="SAME")
    tconv = tp.nn.Conv2D(2, 3, 3, stride=2, padding="SAME")
    _carry(jconv, tconv)
    jx, tx = _input((1, 2, 8, 8), 8, grad=False)
    j, t = jconv(jx), tconv(tx)
    assert list(t.shape) == list(j.shape) == [1, 3, 4, 4]
    _close(t, j)


def test_batch_norm_one_value_per_channel_matches_jax():
    """Training on ``[1, C, 1, 1]``: the output is the bias, the batch
    variance 0, and the running statistics move by Paddle's momentum
    with the unbiased factor ``n / max(n - 1, 1)``; gradients as JAX's
    (x's is 0)."""
    jbn, tbn = jp.nn.BatchNorm2D(4), tp.nn.BatchNorm2D(4)
    rng = np.random.RandomState(9)
    arrays = _arrays(jbn)
    arrays["_mean"] = rng.randn(4).astype("float32")
    arrays["_variance"] = rng.rand(4).astype("float32") + 0.5
    arrays["weight"] = rng.randn(4).astype("float32")
    arrays["bias"] = rng.randn(4).astype("float32")
    jbn.set_state_dict(arrays)
    layer_state_from_jax(arrays, tbn)
    for seed in (10, 11):
        _forward_backward(jbn, tbn, (1, 4, 1, 1), seed)
    for name in ("_mean", "_variance"):
        _close(getattr(tbn, name), getattr(jbn, name))
    np.testing.assert_allclose(tbn._variance.numpy(),
                               0.81 * arrays["_variance"], rtol=1e-6)


@pytest.mark.parametrize("out,shape", [((1, 1), (2, 3, 7, 7)),
                                       (2, (2, 3, 8, 6)),
                                       (3, (1, 2, 7, 7)),
                                       ((2, 3), (1, 2, 5, 7))],
                         ids=["global", "divisible", "uneven", "uneven_hw"])
def test_adaptive_avg_pool2d_matches_jax(out, shape):
    _forward_backward(jp.nn.AdaptiveAvgPool2D(out),
                      tp.nn.AdaptiveAvgPool2D(out), shape)


def test_linear_relu_flatten_sequential_match_jax():
    made = []
    for pkg in (jp, tp):
        made.append(pkg.nn.Sequential(
            pkg.nn.Flatten(), pkg.nn.Linear(12, 7), pkg.nn.ReLU(),
            pkg.nn.Linear(7, 3)))
    jseq, tseq = made
    assert set(tseq.state_dict()) == set(jseq.state_dict())
    assert len(tseq) == 4 and isinstance(tseq[1], tp.nn.Linear)
    _carry(jseq, tseq)
    _forward_backward(jseq, tseq, (5, 3, 2, 2))


@pytest.mark.parametrize("kw", [{}, {"ignore_index": 1}],
                         ids=["mean", "ignore"])
def test_cross_entropy_matches_jax(kw):
    jx, tx = _input((6, 5), 7)
    y = np.array([0, 1, 4, 1, 2, 3], "int64")
    jl = JF.cross_entropy(jx, jp.to_tensor(y), **kw)
    tl = TF.cross_entropy(tx, tp.to_tensor(y), **kw)
    _close(tl, jl)
    jl.backward()
    tl.backward()
    _close(tx.grad, jx.grad)


def test_bottleneck_block_matches_jax():
    blocks = []
    for pkg, res in ((jp, jresnet), (tp, tresnet)):
        down = pkg.nn.Sequential(pkg.nn.Conv2D(8, 16, 1, stride=2,
                                               bias_attr=False),
                                 pkg.nn.BatchNorm2D(16))
        blocks.append(res.BottleneckBlock(8, 4, stride=2, downsample=down))
    jblock, tblock = blocks
    assert set(tblock.state_dict()) == set(jblock.state_dict())
    _carry(jblock, tblock)
    jx, tx = _input((2, 8, 10, 10), 9)
    jy, ty = jblock(jx), tblock(tx)
    _close(ty, jy)
    jy.sum().backward()
    ty.sum().backward()
    jparams = dict(jblock.named_parameters())
    for name, p in [("x", tx), *tblock.named_parameters()]:
        want = np.asarray((jx if name == "x" else jparams[name]).grad.numpy())
        got = p.grad.numpy()
        assert np.abs(got - want).max() <= TOL * np.abs(want).max(), name


@pytest.mark.parametrize("kw", [{}, {"use_nesterov": True},
                                {"weight_decay": 0.01},
                                {"multi_precision": True}],
                         ids=["plain", "nesterov", "wd", "bf16_master"])
def test_momentum_matches_jax(kw):
    bf16 = kw.get("multi_precision", False)
    rng = np.random.RandomState(0)
    arrays = [rng.randn(4, 3).astype("float32"), rng.randn(5).astype("float32")]
    grads = [[rng.randn(*a.shape).astype("float32") * 0.1 for a in arrays]
             for _ in range(3)]
    jps = [jp.to_tensor(a, dtype="bfloat16" if bf16 else None)
           for a in arrays]
    tps = [tp.Parameter(tp.to_tensor(a, dtype="bfloat16" if bf16 else None))
           for a in arrays]
    for p in jps:
        p.stop_gradient = False
    jopt = jp.optimizer.Momentum(0.1, 0.9, parameters=jps, **kw)
    topt = tp.optimizer.Momentum(0.1, 0.9, parameters=tps, **kw)
    for g in grads:
        for p, q, a in zip(jps, tps, g):
            p.grad = jp.to_tensor(a, dtype=p.dtype)
            q.grad = tp.to_tensor(a).to(q.dtype)
        jopt.step()
        topt.step()
    for p, q in zip(jps, tps):
        np.testing.assert_allclose(q.float().numpy(),
                                   np.asarray(p.numpy()).astype("float32"),
                                   rtol=1e-6, atol=1e-6 if not bf16 else 1e-2)
        if bf16:
            jm = np.asarray(jopt._accumulators[id(p)]["master_weight"]
                            .numpy())
            tm = topt._accumulators[id(q)]["master_weight"].numpy()
            np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=1e-6)


def _numpy_draws(rng):
    """The JAX initializers' distributions drawn with numpy: building
    the JAX resnet18 with ``jax.random`` compiles a draw for every
    parameter shape (~20 s on one core); the weights are carried to
    the port either way."""
    def kaiming(self, shape, dtype=None):
        fan_in = self._fan_in or jinit._fan_in_out(shape)[0]
        limit = self._gain() * np.sqrt(3.0 / fan_in)
        return jnp.asarray(rng.uniform(-limit, limit, shape), "float32")

    def xavier(self, shape, dtype=None):
        fi, fo = jinit._fan_in_out(shape)
        std = self.gain * np.sqrt(2.0 / (fi + fo))
        return jnp.asarray(std * rng.randn(*shape), "float32")

    return {jinit.KaimingUniform: kaiming, jinit.XavierNormal: xavier}


@pytest.fixture(scope="module")
def jax_resnet18():
    with pytest.MonkeyPatch.context() as mp:
        for cls, draw in _numpy_draws(np.random.RandomState(0)).items():
            mp.setattr(cls, "__call__", draw)
        return jresnet.resnet18(num_classes=10)


def _loss(pkg_f):
    return lambda net, x, y: pkg_f.cross_entropy(net(x), y)


def test_resnet18_three_momentum_steps_match_jax(jax_resnet18):
    jm = jax_resnet18
    tm = tresnet.resnet18(num_classes=10)
    assert set(tm.state_dict()) == set(jm.state_dict())
    _carry(jm, tm)
    lr = 1e-3
    jstep = JTrainStep(jm, _loss(JF), jp.optimizer.Momentum(
        lr, 0.9, parameters=jm.parameters()))
    tstep = TrainStep(tm, _loss(TF), tp.optimizer.Momentum(
        lr, 0.9, parameters=tm.parameters()))
    rng = np.random.RandomState(0)
    xs = rng.rand(3, 2, 3, 64, 64).astype("float32")
    ys = rng.randint(0, 10, (3, 2)).astype("int64")
    for x, y in zip(xs, ys):
        jl = float(jstep(jp.to_tensor(x), jp.to_tensor(y)).item())
        tl = float(tstep(tp.to_tensor(x), tp.to_tensor(y)).item())
        assert abs(tl - jl) <= 1e-4 * abs(jl), (tl, jl)
    want, got = _arrays(jm), {k: v.numpy() for k, v in tm.state_dict().items()}
    for name, a in want.items():
        if name.endswith(("_mean", "_variance")):
            assert np.abs(got[name] - a).max() <= 1e-4 * np.abs(a).max(), name
        else:
            np.testing.assert_allclose(got[name], a, rtol=0, atol=1e-5,
                                       err_msg=name)


def test_amp_o2_keeps_the_jax_buffer_dtypes():
    nets = []
    for pkg in (jp, tp):
        pkg.seed(3)
        net = pkg.nn.Sequential(
            pkg.nn.Conv2D(3, 8, 3, padding=1), pkg.nn.BatchNorm2D(8),
            pkg.nn.ReLU(), pkg.nn.AdaptiveAvgPool2D(1), pkg.nn.Flatten(),
            pkg.nn.Linear(8, 4))
        nets.append(net)
    jnet, tnet = nets
    _carry(jnet, tnet)
    losses = []
    x = np.random.RandomState(1).rand(4, 3, 8, 8).astype("float32")
    y = np.array([0, 1, 2, 3], "int64")
    for pkg, f, net, Step in ((jp, JF, jnet, JTrainStep),
                              (tp, TF, tnet, TrainStep)):
        opt = pkg.optimizer.Momentum(0.1, 0.9, parameters=net.parameters())
        net, opt = pkg.amp.decorate(net, opt, level="O2", dtype="bfloat16")
        step = Step(net, _loss(f), opt)
        xb = pkg.to_tensor(x).astype("bfloat16")
        losses.append([float(step(xb, pkg.to_tensor(y)).item())
                       for _ in range(2)])
    assert np.dtype(jnet[1]._mean.dtype).name == "bfloat16"
    assert tnet[1]._mean.dtype == tnet[1]._variance.dtype == torch.bfloat16
    assert tnet[0].weight.dtype == torch.bfloat16
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-2)
    np.testing.assert_allclose(tnet[1]._mean.float().numpy(),
                               np.asarray(jnet[1]._mean.numpy()).astype(
                                   "float32"), rtol=2e-2, atol=2e-2)
