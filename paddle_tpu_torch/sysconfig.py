"""``paddle.sysconfig`` (counterpart of ``paddle_tpu/sysconfig.py``):
``get_include`` is the directory of the headers a plugin compiles
against (``plugin_abi.h``), ``get_lib`` that of the port's native host
library."""
import os

__all__ = ["get_include", "get_lib"]

_ROOT = os.path.dirname(os.path.abspath(__file__))


def get_include():
    return os.path.join(_ROOT, "utils", "csrc")


def get_lib():
    return os.path.join(_ROOT, "core", "native")
