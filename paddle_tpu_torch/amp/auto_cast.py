"""Mixed precision: ``auto_cast`` (O1/O2 per-op casts) and ``decorate``.

Counterpart of ``paddle_tpu/amp/auto_cast.py``. The JAX package's
dispatcher asks :func:`amp_op_dtype` for every op by its name before it
runs it and casts the op's floating inputs to the answer
(``paddle_tpu/core/dispatch.py:109-111``). The port has no dispatcher
around every op, so its functional entries ask at the same boundaries
under the same names (:func:`amp_cast`): ``linear`` /
``linear_nobias``, ``matmul``, ``layer_norm``, ``softmax``, ``gelu``,
``embedding``, ``dropout``, ``cross_entropy``, ``sdpa`` (the attention
entry) and the GPT model's ``fused_block_stack``, which runs its
inside uncast (:func:`autocast_suspended`: the JAX stack is one op over
raw arrays). The lists are Paddle's, not ``torch.autocast``'s. O1
casts white-list ops to the low dtype and black-list ops to float32 and
leaves the rest ("gray") in their inputs' dtypes; O2 casts every op
but the black list low. Tensor methods (``+``, ``reshape``) ask
nothing: under O1 they are gray, as in the JAX package.

``decorate`` (O2) casts the model's floating parameters to the low
dtype and turns on float32 master weights in the optimizers
(``multi_precision``).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["auto_cast", "amp_guard", "amp_op_dtype", "amp_cast",
           "autocast_suspended", "current_amp_state", "white_list",
           "black_list", "decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_state = threading.local()

# O1 lists: the JAX package's (Paddle's fp16 white and black lists)
white_list = {
    "matmul", "linear", "linear_nobias", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum_2", "einsum_3", "sdpa", "addmm", "mm", "bmm",
}
black_list = {
    "exp", "log", "log2", "log10", "log1p", "expm1",
    "reduce_mean", "reduce_sum", "logsumexp",
    "cross_entropy", "nll_loss", "bce_loss", "bce_logits_loss",
    "softmax", "log_softmax", "layer_norm", "batch_norm_train",
    "batch_norm_infer", "instance_norm", "group_norm",
    "p_norm", "kl_div", "cumsum", "softmax_with_cross_entropy",
    "sigmoid_focal_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
}
# ops the hook never touches (identity, casting and assign plumbing)
_NEVER_CAST = {"cast", "assign", "getitem", "setitem", "scale"}


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {list(_DTYPES)}, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


class _AmpState:
    __slots__ = ("enabled", "dtype", "level", "custom_white", "custom_black")

    def __init__(self, enabled, dtype, level, custom_white=None,
                 custom_black=None):
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.custom_white = set(custom_white or ())
        self.custom_black = set(custom_black or ())


def current_amp_state() -> Optional[_AmpState]:
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


class auto_cast:
    """Context manager: ``with paddle.amp.auto_cast(level="O1"):``."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in ("O0", "O1", "O2"):
            raise ValueError("level must be O0/O1/O2")
        self._st = _AmpState(enable and level != "O0", _to_dtype(dtype),
                             level, custom_white_list, custom_black_list)

    def __enter__(self):
        if not hasattr(_state, "stack"):
            _state.stack = []
        _state.stack.append(self._st)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


amp_guard = auto_cast


class autocast_suspended:
    """Ops inside cast nothing (an op whose inside the JAX package runs
    on raw arrays, past its dispatcher)."""

    def __enter__(self):
        if not hasattr(_state, "stack"):
            _state.stack = []
        _state.stack.append(None)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


def amp_op_dtype(op_name: str) -> Optional[torch.dtype]:
    """The dtype the op's floating inputs are cast to, or None."""
    st = current_amp_state()
    if st is None or not st.enabled or op_name in _NEVER_CAST:
        return None
    if st.level == "O1":
        if op_name in st.custom_black or (
                op_name in black_list and op_name not in st.custom_white):
            return torch.float32
        if op_name in white_list or op_name in st.custom_white:
            return st.dtype
        return None                     # gray: the inputs' dtypes
    if op_name in black_list or op_name in st.custom_black:
        return torch.float32
    return st.dtype


def amp_cast(op_name: str, *tensors):
    """``tensors`` with each floating one cast as :func:`amp_op_dtype`
    says for ``op_name`` (None entries and other dtypes pass through).
    Returns a tuple (one entry per argument)."""
    dtype = amp_op_dtype(op_name)
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != dtype else t
                 for t in tensors)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """Paddle's ``amp.decorate``. ``level="O2"`` casts every floating
    parameter and buffer of ``models`` to ``dtype`` in place (the
    parameter objects stay, so optimizers built on them keep them) and,
    unless ``master_weight=False``, sets ``multi_precision`` on
    ``optimizers``; ``save_dtype`` makes each model's ``state_dict`` give
    its floating tensors in that dtype (``_save_dtype``, as the JAX
    package sets it). Returns ``models`` (and ``optimizers``) as given."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError("level must be O0/O1/O2")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {list(_DTYPES)}, got {dtype!r}")
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        for m in model_list:
            m.to(dtype=_DTYPES[dtype])
    if save_dtype is not None:
        for m in model_list:
            m._save_dtype = save_dtype
    if optimizers is None:
        return models
    opt_list = list(optimizers) if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    if level == "O2" and master_weight is not False:
        for o in opt_list:
            o._multi_precision = True
    return models, optimizers
