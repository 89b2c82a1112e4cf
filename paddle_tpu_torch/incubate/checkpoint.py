"""Auto-checkpoint: resume an epoch loop after a restart (counterpart of
``paddle_tpu/incubate/checkpoint.py``).

``for epoch in train_epoch_range(N, model=m, optimizer=o): ...`` saves
the model's and the optimizer's state dicts (``paddle.save``) and a
``train_status.json`` progress record under
``$PADDLE_CHECKPOINT_DIR/<name>`` (default ``./auto_checkpoint/``,
``name`` from ``PADDLE_JOB_ID`` or ``default_job``) after each epoch,
or every ``save_checkpoint_inter`` seconds (``PADDLE_SAVE_CHECKPOINT_INTER``)
and after the last. Every file lands through ``os.replace`` of a
``.tmp`` beside it, the status record last, so a kill mid-save leaves
the previous epoch's checkpoint whole; only trainer 0
(``PADDLE_TRAINER_ID``) writes. A new ``train_epoch_range`` over the
same directory restores the state (``paddle.load``, tensors on the
current device) and starts at the first unfinished epoch.
"""
from __future__ import annotations

import json
import os
import time

from ..framework.io import load as _load
from ..framework.io import save as _save

__all__ = ["ExeTrainStatus", "train_epoch_range"]


class ExeTrainStatus:
    """The progress record kept beside the weights."""

    def __init__(self, epoch_no=-1):
        self.epoch_no = epoch_no

    def to_dict(self):
        return {"epoch_no": self.epoch_no}


class _EpochRange:
    def __init__(self, max_epoch_num, save_checkpoint_inter=None, name=None):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name or os.environ.get("PADDLE_JOB_ID", "default_job")
        self._dir = os.path.join(
            os.environ.get("PADDLE_CHECKPOINT_DIR", "./auto_checkpoint"),
            self.name)
        self._inter = (save_checkpoint_inter
                       if save_checkpoint_inter is not None
                       else float(os.environ.get(
                           "PADDLE_SAVE_CHECKPOINT_INTER", "0")))
        self._last_save = 0.0
        self._models = []
        self._optimizers = []
        os.makedirs(self._dir, exist_ok=True)
        self.status = ExeTrainStatus(self._load_status())

    def attach(self, model=None, optimizer=None):
        """Register a model and/or optimizer whose state is kept."""
        if model is not None:
            self._models.append(model)
        if optimizer is not None:
            self._optimizers.append(optimizer)
        return self

    def _status_path(self):
        return os.path.join(self._dir, "train_status.json")

    def _load_status(self) -> int:
        try:
            with open(self._status_path()) as f:
                return int(json.load(f)["epoch_no"])
        except (OSError, ValueError, KeyError):
            return -1

    def _files(self):
        for i, m in enumerate(self._models):
            yield m, os.path.join(self._dir, f"model_{i}.pdparams")
        for i, o in enumerate(self._optimizers):
            yield o, os.path.join(self._dir, f"opt_{i}.pdopt")

    def _save(self, epoch_no):
        if int(os.environ.get("PADDLE_TRAINER_ID", "0")) == 0:
            for obj, path in self._files():
                _save(obj.state_dict(), path + ".tmp")
                os.replace(path + ".tmp", path)
            tmp = self._status_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"epoch_no": epoch_no, "name": self.name,
                           "timestamp": time.time()}, f)
            os.replace(tmp, self._status_path())
        self.status.epoch_no = epoch_no
        self._last_save = time.monotonic()

    def restore(self):
        for obj, path in self._files():
            if os.path.exists(path):
                obj.set_state_dict(_load(path))

    def __iter__(self):
        start = self.status.epoch_no + 1
        if start > 0:
            self.restore()
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            now = time.monotonic()
            if self._inter <= 0 or now - self._last_save >= self._inter \
                    or epoch == self.max_epoch_num - 1:
                self._save(epoch)


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None,
                      name=None, model=None, optimizer=None):
    """The epochs left of ``max_epoch_num`` (see the module docstring)."""
    r = _EpochRange(max_epoch_num, save_checkpoint_inter, name)
    r.attach(model, optimizer)
    return r
