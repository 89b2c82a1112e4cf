"""The top-level ops of the Paddle API that the port has so far."""
from .creation import *  # noqa: F401,F403
from .creation import __all__ as _creation
from .manipulation import *  # noqa: F401,F403
from .manipulation import __all__ as _manipulation
from .math import *  # noqa: F401,F403
from .math import __all__ as _math
from .reduction import *  # noqa: F401,F403
from .reduction import __all__ as _reduction

__all__ = [*_creation, *_math, *_reduction, *_manipulation]
