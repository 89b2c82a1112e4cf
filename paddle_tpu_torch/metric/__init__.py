"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and ``accuracy``.

They count on the host in numpy, as the JAX package's do: a prediction
or label given as a ``Tensor`` is read back once per update. What the
JAX package returns as a ``Tensor`` is a port ``Tensor`` on the device
its input came from.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import to_numpy, to_tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]

# numpy 2 names the trapezoid rule ``trapezoid`` and deprecates ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _np(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _place(x):
    return x.device if isinstance(x, torch.Tensor) else "cpu"


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """``[N, maxk]`` float32: 1 where the i-th highest score is the
        label (an ``[N, 1]`` label is read as ``[N]``)."""
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        top = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        correct = top == label_np[..., None]
        return to_tensor(correct.astype(np.float32), place=_place(pred))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            n_ok = float(c[..., :k].sum())
            self.total[i] += n_ok
            self.count[i] += num
            accs.append(n_ok / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p, lab = _np(preds).round(), _np(labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p, lab = _np(preds).round(), _np(labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p, lab = _np(preds), _np(labels).ravel()
        if p.ndim == 2:
            p = p[:, -1]
        idx = np.clip((p * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        for i, positive in zip(idx, lab):
            if positive:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # the trapezoid rule over the thresholds, highest first
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(_trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None,  # noqa: A002
             name=None):
    """The share of rows whose label is among the ``k`` highest scores,
    a float32 ``Tensor`` on ``input``'s device."""
    pred_np, label_np = _np(input), _np(label)
    if label_np.ndim == 2 and label_np.shape[1] == 1:
        label_np = label_np[:, 0]
    top = np.argsort(-pred_np, axis=-1)[:, :k]
    ok = (top == label_np[:, None]).any(axis=1).mean()
    return to_tensor(np.asarray(ok, np.float32), place=_place(input))
