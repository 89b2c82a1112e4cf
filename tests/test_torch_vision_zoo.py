"""The port's vision model zoo against the JAX package's, on the CPU.

For every model family of ``paddle_tpu.vision.models`` the JAX model is
built (its initializers drawing from numpy, for speed: ``jax.random``
would compile a draw for every parameter shape), its weights carried to
the port's model with ``layer_state_from_jax`` (which raises on a name
or shape that differs), and the eval logits of the same seeded input
compared at rtol = atol = 1e-4, each tensor scaled by its largest value
(a deep random network's logits reach the hundreds). Inputs are narrow:
32 x 32 with 10 classes, 75 x 75 for Inception-v3 (its stem needs it),
``scale=0.25`` where a factory takes it; batch 2. The JAX forward runs
under ``jit.to_static`` (one compile, not one per op).

The module also checks that the port exports every name of
``paddle_tpu.vision.models``, that the wide and ResNeXt factories build
what the JAX ones build, that ``_make_divisible`` gives the JAX widths
and that GoogLeNet returns its three outputs in eval. One training step
of three models is in ``test_torch_vision_zoo_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.initializer as jinit  # noqa: E402
from paddle_tpu.vision import models as jm  # noqa: E402

import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.vision import models as tm  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4

# factory, keyword arguments, input size
FAMILIES = {
    "alexnet": ("alexnet", {}, 64),
    "vgg": ("vgg11", {"batch_norm": True}, 32),
    "vgg_plain": ("vgg13", {}, 32),
    "squeezenet1_0": ("squeezenet1_0", {}, 32),
    "squeezenet1_1": ("squeezenet1_1", {}, 32),
    "mobilenet_v1": ("mobilenet_v1", {"scale": 0.25}, 32),
    "mobilenet_v2": ("mobilenet_v2", {"scale": 0.25}, 32),
    "mobilenet_v3_small": ("mobilenet_v3_small", {"scale": 0.25}, 32),
    "mobilenet_v3_large": ("mobilenet_v3_large", {"scale": 0.25}, 32),
    "shufflenet_v2": ("shufflenet_v2_x0_25", {}, 32),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", {}, 32),
    "densenet": ("densenet121", {}, 32),
    "googlenet": ("googlenet", {}, 32),
    "inception_v3": ("inception_v3", {}, 75),
    "resnext": ("resnext50_32x4d", {}, 32),
    "wide_resnet": ("wide_resnet50_2", {}, 32),
}


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


def _twins(factory, kw):
    jmodel = getattr(jm, factory)(num_classes=10, **kw)
    tmodel = getattr(tm, factory)(num_classes=10, **kw)
    tm.layer_state_from_jax(_arrays(jmodel), tmodel)
    return jmodel, tmodel


def _scaled_close(t, j):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1.0)
    np.testing.assert_allclose(t / scale, j / scale, rtol=TOL, atol=TOL)


def _outputs(y):
    return y if isinstance(y, (list, tuple)) else [y]


def test_exports_every_jax_name():
    names = [n for n in dir(jm) if not n.startswith("_")
             and n not in ("annotations",)]
    missing = [n for n in names if not hasattr(tm, n)]
    assert not missing
    assert set(names) - {"alexnet", "densenet", "googlenet", "inceptionv3",
                         "lenet", "mobilenetv1", "mobilenetv2",
                         "mobilenetv3", "resnet", "shufflenetv2",
                         "squeezenet", "vgg"} <= set(tm.__all__)


def test_resnet_family_factories_match_jax(monkeypatch):
    """The eight wide / ResNeXt factories call ``ResNet`` with the JAX
    factories' block, depth, width and groups (the two built at depth 50
    are held to the JAX models below); ``pretrained=True`` raises."""
    from paddle_tpu.vision.models import resnet as jres
    from paddle_tpu_torch.vision.models import resnet as tres

    def spy(module):
        def build(block, depth, **kwargs):
            return block.__name__, depth, kwargs
        monkeypatch.setattr(module, "ResNet", build)

    spy(jres)
    spy(tres)
    for name in ("wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
                 "resnext101_32x4d", "resnext50_64x4d", "resnext101_64x4d",
                 "resnext152_32x4d", "resnext152_64x4d"):
        assert getattr(tres, name)(num_classes=7) == getattr(jres, name)(
            num_classes=7), name
        with pytest.raises(NotImplementedError):
            getattr(tm, name)(pretrained=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_logits_match_jax(family, numpy_draws):
    factory, kw, size = FAMILIES[family]
    jmodel, tmodel = _twins(factory, kw)
    jmodel.eval()
    tmodel.eval()
    x = np.random.RandomState(1).randn(2, 3, size, size).astype("float32")
    jy = _outputs(jp.jit.to_static(jmodel)(jp.to_tensor(x)))
    with torch.no_grad():
        ty = _outputs(tmodel(tp.to_tensor(x)))
    assert len(ty) == len(jy)
    for t, j in zip(ty, jy):
        assert tuple(t.shape) == (2, 10)
        _scaled_close(t.numpy(), j.numpy())


def test_googlenet_returns_three_outputs_in_eval(numpy_draws):
    model = tm.googlenet(num_classes=10)
    model.eval()
    with torch.no_grad():
        out = model(tp.rand([1, 3, 32, 32]))
    assert isinstance(out, list) and len(out) == 3
    assert tuple(tm.googlenet(num_classes=0)(tp.rand([1, 3, 32, 32]))
                 .shape) == (1, 1024, 1, 1)


def test_make_divisible_widths_match_jax():
    from paddle_tpu.vision.models import mobilenetv2 as jv2, mobilenetv3 as jv3
    from paddle_tpu_torch.vision.models import (mobilenetv2 as tv2,
                                                mobilenetv3 as tv3)
    for v in np.linspace(0.5, 2000.0, 4001):
        for d in (8, 16):
            assert tv3._make_divisible(v, d) == jv3._make_divisible(v, d)
            assert tv2._make_divisible(v, d) == jv2._make_divisible(v, d)
