"""``densenet121``'s training step against the JAX package's, on the
CPU: the check of ``test_torch_vision_zoo_train.py`` (one
``Momentum(1e-3, 0.9)`` ``TrainStep`` at 2 x 3 x 64 x 64, the loss and
every parameter at rtol = atol = 1e-4 of each parameter's scale), in a
file of its own because the JAX step of a 121-layer network compiles
for ~45 s on one core.
"""
import pytest

pytest.importorskip("torch")

from test_torch_vision_zoo_train import (cpu, numpy_draws,  # noqa: E402,F401
                                         one_momentum_step, one_thread)


def test_one_momentum_step_matches_jax(numpy_draws):
    one_momentum_step("densenet121", {})
