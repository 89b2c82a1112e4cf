"""``paddle.hapi`` of the port: ``Model``, ``summary``, ``flops`` and the
callbacks."""
from . import callbacks  # noqa: F401
from .model import Model, flops, summary  # noqa: F401

__all__ = ["Model", "summary", "flops", "callbacks"]
