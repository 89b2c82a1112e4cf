"""``paddle.incubate.multiprocessing``: the standard ``multiprocessing``
namespace with the port's ``Tensor`` reducer installed (see
``reductions.py``)."""
from multiprocessing import *  # noqa: F401,F403

from .reductions import (init_reductions, reduce_tensor,  # noqa: F401
                         tensor_shm_unlink_all)

init_reductions()
