"""``paddle.callbacks`` (reference ``python/paddle/callbacks/``): the hapi
callbacks (counterpart of ``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau, VisualDL,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau", "VisualDL"]
