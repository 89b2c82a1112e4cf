"""``paddle.incubate.asp``: n:m structured sparsity (counterpart of
``paddle_tpu/incubate/asp/__init__.py``).

The mask algorithms are the JAX package's numpy, copied here (the port
imports nothing of it): ``get_mask_1d`` keeps the ``n`` largest
magnitudes of every ``m`` consecutive elements along the flattened last
axis (``np.argsort`` of the negated magnitudes, so ties keep the
earlier index), ``get_mask_2d_greedy`` walks each ``m x m`` block in
that order keeping at most ``n`` a row and a column (a Python loop per
block). They take a tensor or an array and run on the host; given a
tensor they return the mask as a tensor of its dtype on its device.
``prune_model`` multiplies each prunable weight (a ``Linear``'s or a
``Conv2D``'s) by its mask on the weight's device and hangs the mask on
the weight (``_asp_mask``); a ``Linear`` weight is ``[in, out]``, so
its mask is taken on the transpose (n:m along the reduction axis).
``decorate(optimizer)`` re-applies the masks after every step.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...core.tensor import to_numpy
from ...nn.layer.common import Linear
from ...nn.layer.conv import Conv2D
from ...nn.layer.layers import Layer

__all__ = [
    "calculate_density", "get_mask_1d", "check_mask_1d",
    "get_mask_2d_greedy", "check_mask_2d", "prune_model", "decorate",
    "reset_excluded_layers", "set_excluded_layers", "ASPHelper",
]


def _host(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _like(mask: np.ndarray, x):
    """The mask as ``x`` is: a tensor of its dtype on its device, or an
    array."""
    if isinstance(x, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(mask)).to(
            device=x.device, dtype=x.dtype)
    return mask


def calculate_density(x) -> float:
    arr = _host(x)
    return float(np.count_nonzero(arr)) / max(arr.size, 1)


def _mask_1d(arr: np.ndarray, n: int, m: int) -> np.ndarray:
    shape = arr.shape
    flat = arr.reshape(-1)
    pad = (-flat.size) % m
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    groups = np.abs(flat).reshape(-1, m)
    order = np.argsort(-groups, axis=1)     # descending |.|
    mask = np.zeros_like(groups, dtype=bool)
    np.put_along_axis(mask, order[:, :n], True, axis=1)
    mask = mask.reshape(-1)
    if pad:
        mask = mask[:-pad]
    return mask.reshape(shape).astype(arr.dtype)


def get_mask_1d(mat, n=2, m=4):
    return _like(_mask_1d(_host(mat), n, m), mat)


def check_mask_1d(mat, n=2, m=4) -> bool:
    flat = _host(mat).reshape(-1)
    pad = (-flat.size) % m
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    return bool((np.count_nonzero(flat.reshape(-1, m), axis=1) <= n).all())


def _mask_2d_greedy(arr: np.ndarray, n: int, m: int) -> np.ndarray:
    if arr.ndim != 2:
        return _mask_1d(arr, n, m)
    h, w = arr.shape
    padded = np.pad(np.abs(arr), ((0, (-h) % m), (0, (-w) % m)))
    mask = np.zeros_like(padded, dtype=bool)
    for bi in range(0, padded.shape[0], m):
        for bj in range(0, padded.shape[1], m):
            block = padded[bi:bi + m, bj:bj + m]
            row_cnt = np.zeros(m, int)
            col_cnt = np.zeros(m, int)
            for idx in np.argsort(-block, axis=None):
                r, c = divmod(int(idx), m)
                if row_cnt[r] < n and col_cnt[c] < n:
                    mask[bi + r, bj + c] = True
                    row_cnt[r] += 1
                    col_cnt[c] += 1
    return mask[:h, :w].astype(arr.dtype)


def get_mask_2d_greedy(mat, n=2, m=4):
    return _like(_mask_2d_greedy(_host(mat), n, m), mat)


def check_mask_2d(mat, n=2, m=4) -> bool:
    arr = _host(mat)
    if arr.ndim != 2:
        return check_mask_1d(arr, n, m)
    h, w = arr.shape
    padded = np.pad(arr, ((0, (-h) % m), (0, (-w) % m)))
    for bi in range(0, padded.shape[0], m):
        for bj in range(0, padded.shape[1], m):
            block = padded[bi:bi + m, bj:bj + m]
            if (np.count_nonzero(block, axis=1) > n).any() or (
                    np.count_nonzero(block, axis=0) > n).any():
                return False
    return True


_MASK_ALGOS = {
    "mask_1d": _mask_1d,
    "mask_2d_greedy": _mask_2d_greedy,
    "mask_2d_best": _mask_2d_greedy,    # the JAX package's choice
}


class ASPHelper:
    """Mask bookkeeping: the mask hangs on the parameter
    (``p._asp_mask``); excluded layers by ``id``."""

    _excluded: set = set()

    @classmethod
    def reset(cls):
        cls._excluded.clear()

    @staticmethod
    def mask_of(p):
        return getattr(p, "_asp_mask", None)

    @staticmethod
    def set_mask(p, mask):
        p._asp_mask = mask

    @classmethod
    def prunable_params(cls, model: Layer):
        out = []
        for _, layer in model.named_sublayers(include_self=True):
            if isinstance(layer, (Linear, Conv2D)) and \
                    id(layer) not in cls._excluded:
                w = getattr(layer, "weight", None)
                if w is not None and w.requires_grad:
                    out.append(w)
        return out


def set_excluded_layers(model: Layer, layer_names: List[str]):
    names = set(layer_names)
    for name, layer in model.named_sublayers():
        if name in names:
            ASPHelper._excluded.add(id(layer))


def reset_excluded_layers(model=None):
    ASPHelper._excluded.clear()


@torch.no_grad()
def prune_model(model: Layer, n=2, m=4, mask_algo="mask_1d",
                with_mask=True) -> Dict[str, np.ndarray]:
    """Mask every prunable weight in place (n:m along its input axis) and,
    with ``with_mask``, register the mask for a ``decorate``d optimizer.
    Returns the masks as host arrays, keyed by the weight's name (or its
    ``id``)."""
    if mask_algo not in _MASK_ALGOS:
        raise ValueError(f"unknown mask_algo {mask_algo!r}; "
                         f"choose from {sorted(_MASK_ALGOS)}")
    algo = _MASK_ALGOS[mask_algo]
    masks = {}
    for w in ASPHelper.prunable_params(model):
        arr = to_numpy(w)
        if arr.ndim == 2:
            mask = algo(arr.T, n, m).T
        else:
            mask = algo(arr.reshape(arr.shape[0], -1), n, m).reshape(
                arr.shape)
        on_device = _like(mask, w)
        w.mul_(on_device)
        if with_mask:
            ASPHelper.set_mask(w, on_device)
        masks[w.name or str(id(w))] = mask
    return masks


class _DecoratedOptimizer:
    """The optimizer with every registered mask re-applied after each
    step."""

    def __init__(self, optimizer):
        self._inner = optimizer

    def __getattr__(self, item):
        return getattr(self._inner, item)

    @torch.no_grad()
    def _mask(self):
        for p in self._inner._parameter_list:
            mask = ASPHelper.mask_of(p)
            if mask is not None:
                p.mul_(mask)

    def step(self):
        self._inner.step()
        self._mask()

    def minimize(self, loss, *args, **kwargs):
        out = self._inner.minimize(loss, *args, **kwargs)
        self._mask()
        return out


def decorate(optimizer):
    return _DecoratedOptimizer(optimizer)
