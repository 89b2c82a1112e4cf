"""``paddle.vision`` of the port: the ResNet family and LeNet, the
datasets (local files and ``FakeData``) and the numpy transforms."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
