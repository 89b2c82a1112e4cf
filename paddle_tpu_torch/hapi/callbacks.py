"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``;
reference ``python/paddle/hapi/callbacks.py``): ProgBarLogger,
ModelCheckpoint, EarlyStopping, LRScheduler, ReduceLROnPlateau and
VisualDL (scalars kept in memory: no visualdl writer), wired through
``Model.fit`` / ``evaluate`` / ``predict`` by ``config_callbacks``.
"""
from __future__ import annotations

import numbers
import os
import time
from typing import Dict, List

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau", "VisualDL", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    # eval
    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    # predict
    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    """Per-step console logging (reference ``ProgBarLogger``; plain-line
    output rather than a terminal progress bar)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._et0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1  # within-epoch step (the `step` arg is global)
        if self.verbose and self.log_freq and self.steps % self.log_freq == 0:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"Epoch {self.epoch + 1}/{self.epochs} "
                  f"step {self.steps}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"Epoch {epoch + 1}/{self.epochs} done "
                  f"({time.time() - self._et0:.1f}s) {items}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"Eval: {items}")


def _fmt(v):
    if isinstance(v, numbers.Number):
        return f"{v:.4f}"
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], numbers.Number):
        return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"
    return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None
                     else (np.inf if self.mode == "min" else -np.inf))

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(os.path.join(self.params["save_dir"],
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement "
                          f"for {self.wait} evals, stopping")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference semantics: by epoch by
    default, or by step)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("choose one of by_step/by_epoch")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.cooldown_counter = 0
        self.best = np.inf if self.mode == "min" else -np.inf

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(cur):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                from ..optimizer.lr import LRScheduler as Sched

                if isinstance(opt._learning_rate, Sched):
                    return  # scheduler owns the LR
                new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                opt.set_lr(new_lr)
                self.cooldown_counter = self.cooldown
                self.wait = 0
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.2e}")


class VisualDL(Callback):
    """Keeps the scalars a VisualDL writer would log, in memory
    (``scalars``: tag -> [(step, value)]); visualdl itself is not a
    dependency."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self.scalars: Dict[str, list] = {}

    def _add(self, tag, value, step):
        if isinstance(value, (list, tuple)):
            value = value[0] if value else None
        if isinstance(value, numbers.Number):
            self.scalars.setdefault(tag, []).append((step, float(value)))

    def on_train_batch_end(self, step, logs=None):
        for k, v in (logs or {}).items():
            self._add(f"train/{k}", v, step)

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            self._add(f"eval/{k}", v, len(self.scalars.get(f"eval/{k}", [])))


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_dir=None, save_freq=1,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "epochs": epochs, "steps": steps, "verbose": verbose,
        "metrics": metrics or [], "save_dir": save_dir,
    })
    return lst
