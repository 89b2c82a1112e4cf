"""``paddle.vision`` of the port: the model zoo (every model family of
the JAX package), the detection ops (``ops``), the datasets (local files
and ``FakeData``) and the numpy transforms."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
