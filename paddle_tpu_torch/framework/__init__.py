"""``paddle.framework`` of the port: ``save`` / ``load`` and the flag
registry (counterpart of ``paddle_tpu/framework/``)."""
from ..core import dtypes as dtype  # noqa: F401
from ..core.random import seed  # noqa: F401
from . import flags, io  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .io import load, save  # noqa: F401
