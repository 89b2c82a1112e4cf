"""``paddle.utils`` of the port: custom ops, host C++ extensions and
kernel plugins, and Paddle's small helpers (``deprecated``,
``require_version``, ``run_check``, ``try_import``)."""
import functools
import importlib
import warnings

from . import cpp_extension, plugin  # noqa: F401
from .custom_op import LAUNCHES, ShapeDtypeStruct, cuda_op, custom_op
from .plugin import load_kernel_plugin, plugin_abi_header

__all__ = ["custom_op", "cuda_op", "ShapeDtypeStruct", "LAUNCHES",
           "cpp_extension", "plugin", "load_kernel_plugin",
           "plugin_abi_header", "deprecated", "require_version", "run_check",
           "try_import"]


def deprecated(update_to="", since="", reason="", level=0):
    """Mark an API deprecated: a call warns (``level`` >= 1: raises)."""

    def decorator(fn):
        msg = f"API {fn.__module__}.{fn.__name__} is deprecated"
        if since:
            msg += f" since {since}"
        if update_to:
            msg += f"; use {update_to} instead"
        if reason:
            msg += f" ({reason})"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if level >= 1:
                raise RuntimeError(msg)
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def require_version(min_version, max_version=None):
    """Raise unless the package's version lies in ``[min_version,
    max_version]``; True otherwise."""
    from .. import __version__

    def _tup(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())

    cur = _tup(__version__)
    if _tup(min_version) > cur:
        raise RuntimeError(
            f"requires version >= {min_version}, got {__version__}")
    if max_version is not None and _tup(max_version) < cur:
        raise RuntimeError(
            f"requires version <= {max_version}, got {__version__}")
    return True


def run_check():
    """Check the install: a 4 x 4 product on the current device (the
    card unless ``set_device("cpu")``), summed and read back; prints the
    device it ran on and returns its name."""
    import torch

    import paddle_tpu_torch as paddle

    x = paddle.ones([4, 4])
    y = (x @ x).sum()
    if float(y) != 64.0:
        raise RuntimeError(f"run_check: sum(ones(4, 4) @ ones(4, 4)) = "
                           f"{float(y)}, expected 64")
    dev = x.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"paddle_tpu_torch is installed successfully! device: {dev} "
          f"({name})")
    return name


def try_import(name: str):
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"{name} is not available in this environment; install it to "
            f"use this feature") from e
