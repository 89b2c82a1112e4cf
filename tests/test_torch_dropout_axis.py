"""``dropout(axis=...)``: the port's mask against the JAX package's.

The JAX package keeps the raw axes (``paddle_tpu/ops/nn_ops.py:287``):
an axis that is negative or past the last dimension matches no
dimension, and one bit is drawn for the whole tensor. The port does the
same. Non-negative axes draw one bit per index of those axes; both are
held bit for bit on the same generator state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu.nn.functional as JF  # noqa: E402
from paddle_tpu.core import random as jrng  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.core import random as trng  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


def _both(x, seed, **kw):
    jrng.seed(seed)
    trng.default_generator.manual_seed(seed)
    jy = JF.dropout(Tensor(jnp.asarray(x)), **kw)
    ty = TF.dropout(torch.tensor(x), **kw)
    return np.asarray(jy._value), ty.numpy()


def test_negative_axis_draws_one_bit_as_jax():
    """Seed 3, ones [4, 6], p 0.5: the JAX package keeps every value
    (all 2.0), and so does the port."""
    x = np.ones((4, 6), np.float32)
    jy, ty = _both(x, 3, p=0.5, axis=-1)
    np.testing.assert_array_equal(jy, np.full((4, 6), 2.0, np.float32))
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("axis", [-1, -2, [-1], [0, -1], 2, [5]])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_axes_naming_no_dimension_match_jax(axis, seed):
    x = np.random.default_rng(seed).standard_normal((4, 6)).astype(
        np.float32)
    jy, ty = _both(x, seed, p=0.5, axis=axis)
    np.testing.assert_array_equal(ty, jy)
    # the whole tensor kept or dropped by one draw (an axis in range in
    # the list still draws along it)
    if all(a < 0 or a >= 2 for a in np.atleast_1d(axis)):
        assert (ty == 0).all() or (ty != 0).all()


@pytest.mark.parametrize("axis", [0, 1, [0], [1], [0, 1]])
@pytest.mark.parametrize("seed", [1, 3])
def test_non_negative_axes_stay_bit_equal(axis, seed):
    x = np.random.default_rng(seed + 10).standard_normal((4, 6, 3)).astype(
        np.float32)
    jy, ty = _both(x, seed, p=0.5, axis=axis)
    np.testing.assert_array_equal(ty, jy)
    assert np.array_equal(np.signbit(ty), np.signbit(jy))
