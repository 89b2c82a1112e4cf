"""Mixed precision of the port."""
from .auto_cast import decorate

__all__ = ["decorate"]
