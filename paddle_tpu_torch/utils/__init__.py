"""``paddle.utils`` of the port: custom ops."""
from .custom_op import LAUNCHES, ShapeDtypeStruct, cuda_op, custom_op

__all__ = ["custom_op", "cuda_op", "ShapeDtypeStruct", "LAUNCHES"]
