"""``paddle.vision`` of the port: the ResNet family so far."""
from . import models

__all__ = ["models"]
