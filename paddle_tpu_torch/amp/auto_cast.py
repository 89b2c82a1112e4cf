"""Mixed precision: ``decorate`` (counterpart of
``paddle_tpu/amp/auto_cast.py::decorate``).

O2 casts the model's floating parameters to the low dtype and turns on
float32 master weights in the optimizers (``multi_precision``); the
model then runs in that dtype end to end, with LayerNorm, softmax and
the loss in float32 inside their ops. O1's per-op autocast lists and
``GradScaler`` (needed for fp16) are not ported.
"""
from __future__ import annotations

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """Paddle's ``amp.decorate``. ``level="O2"`` casts every floating
    parameter and buffer of ``models`` to ``dtype`` in place (the
    parameter objects stay, so optimizers built on them keep them) and,
    unless ``master_weight=False``, sets ``multi_precision`` on
    ``optimizers``. Returns ``models`` (and ``optimizers``) as given."""
    if save_dtype is not None:
        raise NotImplementedError("save_dtype is not ported")
    if level not in ("O0", "O1", "O2"):
        raise ValueError("level must be O0/O1/O2")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {list(_DTYPES)}, got {dtype!r}")
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        for m in model_list:
            m.to(dtype=_DTYPES[dtype])
    if optimizers is None:
        return models
    opt_list = list(optimizers) if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    if level == "O2" and master_weight is not False:
        for o in opt_list:
            o._multi_precision = True
    return models, optimizers
