"""The top-level ops of the Paddle API (counterpart of
``paddle_tpu/ops/``): creation, random draws, math, logic, reductions
and search, shape and indexing, linear algebra and the tail of
``extras.py``."""
from .creation import *  # noqa: F401,F403
from .creation import __all__ as _creation
from .extras import *  # noqa: F401,F403
from .extras import __all__ as _extras
from .linalg import *  # noqa: F401,F403
from .linalg import __all__ as _linalg
from .logic import *  # noqa: F401,F403
from .logic import __all__ as _logic
from .manipulation import *  # noqa: F401,F403
from .manipulation import __all__ as _manipulation
from .math import *  # noqa: F401,F403
from .math import __all__ as _math
from .random_ops import *  # noqa: F401,F403
from .random_ops import __all__ as _random
from .reduction import *  # noqa: F401,F403
from .reduction import __all__ as _reduction

__all__ = list(dict.fromkeys([*_creation, *_random, *_math, *_logic,
                              *_reduction, *_manipulation, *_linalg,
                              *_extras]))
