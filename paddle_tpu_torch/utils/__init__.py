"""``paddle.utils`` of the port: custom ops, host C++ extensions and
kernel plugins."""
from . import cpp_extension, plugin  # noqa: F401
from .custom_op import LAUNCHES, ShapeDtypeStruct, cuda_op, custom_op
from .plugin import load_kernel_plugin, plugin_abi_header

__all__ = ["custom_op", "cuda_op", "ShapeDtypeStruct", "LAUNCHES",
           "cpp_extension", "plugin", "load_kernel_plugin",
           "plugin_abi_header"]
