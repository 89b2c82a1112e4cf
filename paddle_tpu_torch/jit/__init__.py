"""The train step of the port."""
from .to_static import TrainStep

__all__ = ["TrainStep"]
