"""One training step of zoo models, the port against the JAX package,
on the CPU (``densenet121``'s is in ``test_torch_vision_zoo_densenet.py``,
whose JAX step alone compiles for ~45 s).

``mobilenet_v3_small`` (``scale=0.25``, with its classifier's dropout:
both packages draw the same threefry masks from one seed),
``shufflenet_v2_x0_25`` and ``densenet121`` (10 classes) take one
``Momentum(1e-3, 0.9)`` step through ``TrainStep`` in both packages on
the same weights (the JAX initializers drawing from numpy, carried over
with ``layer_state_from_jax``) and the same seeded batch of 2 x 3 x 64
x 64: the loss and every parameter after the update at rtol = atol =
1e-4, each parameter scaled by its largest value (at least 1).

Why 64 x 64 and lr 1e-3: at batch 2 the last stage's BatchNorm
normalises 2 x (its map's cells) values per channel. At 32 x 32 the map
is 1 x 1, two values, and float32 rounding upstream turns into
gradients that differ at O(1) between any two summation orders (JAX's
own eager and compiled runs disagree too; ``test_torch_vision.py``
records the same for resnet18). At 64 x 64 the gradients agree to
~1e-4 of their size, and lr 1e-3 keeps what is left of that in the
parameters under 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.core.random as jrandom  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu.nn.initializer as jinit  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.vision import models as jm  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import random as trandom  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.vision import models as tm  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4
LR = 1e-3


@pytest.fixture(autouse=True)
def cpu():
    saved = tdevice._CURRENT[0]
    tp.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture
def numpy_draws(monkeypatch):
    """Every JAX initializer drawing N(0, 0.1^2) (biases too) with numpy."""
    rng = np.random.RandomState(0)
    for name in dir(jinit):
        cls = getattr(jinit, name)
        if isinstance(cls, type) and issubclass(cls, jinit.Initializer):
            monkeypatch.setattr(
                cls, "__call__", lambda self, shape, dtype=None: jnp.asarray(
                    0.1 * rng.randn(*shape), "float32"))


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _scaled_close(t, j):
    scale = max(float(np.abs(j).max()), 1.0)
    np.testing.assert_allclose(t / scale, j / scale, rtol=TOL, atol=TOL)


def one_momentum_step(factory, kw):
    """One ``TrainStep`` of ``factory(num_classes=10, **kw)`` in both
    packages from the same weights and batch; asserts the loss and every
    parameter after the update."""
    jmodel = getattr(jm, factory)(num_classes=10, **kw)
    tmodel = tm.layer_state_from_jax(
        _arrays(jmodel), getattr(tm, factory)(num_classes=10, **kw))
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 64, 64).astype("float32")
    y = rng.randint(0, 10, (2,)).astype("int64")
    jopt = jp.optimizer.Momentum(LR, 0.9, parameters=jmodel.parameters())
    topt = tp.optimizer.Momentum(LR, 0.9, parameters=tmodel.parameters())
    jrandom.seed(5)
    trandom.default_generator.manual_seed(5)
    jl = JTrainStep(jmodel, lambda n, a, b: JF.cross_entropy(n(a), b),
                    jopt)(jp.to_tensor(x), jp.to_tensor(y))
    tl = TrainStep(tmodel, lambda n, a, b: TF.cross_entropy(n(a), b),
                   topt)(tp.to_tensor(x), tp.to_tensor(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    jstate = _arrays(jmodel)
    for name, p in tmodel.named_parameters():
        _scaled_close(p.detach().numpy(), jstate[name])


@pytest.mark.parametrize("factory,kw", [
    ("mobilenet_v3_small", {"scale": 0.25}), ("shufflenet_v2_x0_25", {})])
def test_one_momentum_step_matches_jax(factory, kw, numpy_draws):
    one_momentum_step(factory, kw)
