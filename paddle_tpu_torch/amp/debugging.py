"""``paddle.amp.debugging``: numeric anomaly detection (counterpart of
``paddle_tpu/amp/debugging.py``; reference
``python/paddle/amp/debugging.py``).

- :func:`check_numerics` counts a tensor's NaNs, infinities and zeros on
  its device and reads the three counts with one host read; in the abort
  mode it raises ``FloatingPointError`` on a NaN or an infinity.
- :func:`enable_tensor_checker` pushes the current ``FLAGS_check_nan_inf``
  and sets it: every op on a port ``Tensor`` then checks its floating
  outputs and raises at the first NaN or infinity.
  :func:`disable_tensor_checker` pops the state back. A config with
  ``enable=False`` pushes without changing anything, so the pairing stays
  balanced; a mode other than abort raises ``NotImplementedError``, as
  the JAX package's does.
- The JAX package also turns on ``jax_debug_nans``, so a jitted function
  raises at a NaN. The port's counterpart: while ``FLAGS_check_nan_inf``
  is on, ``jit.to_static`` runs every signature eagerly (a CUDA graph's
  replay runs no Python, so nothing could check it), and its
  ``capture_report()`` gives that as the reason; once the flag is off
  again, the signature is captured as before.
- The operator-stats functions are the JAX package's stubs.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from ..core.tensor import Tensor
from ..framework.flags import get_flags, set_flags

__all__ = ["DebugMode", "check_numerics", "enable_tensor_checker",
           "disable_tensor_checker", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "TensorCheckerConfig"]


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    """``enable`` and ``debug_mode`` are honoured; the per-op filter
    fields are accepted for the reference's signature and inert (the
    live check covers every op)."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """``(num_nan, num_inf, num_zero)`` of ``tensor`` as int64 scalars on
    its device, counted there with one host read; raises
    ``FloatingPointError`` on a NaN or an infinity in the abort mode."""
    t = tensor if isinstance(tensor, torch.Tensor) else torch.as_tensor(
        np.asarray(tensor))
    with torch._C.DisableTorchFunctionSubclass():
        t = t.detach()
        counts = torch.stack([torch.isnan(t).sum(), torch.isinf(t).sum(),
                              (t == 0).sum()])
        n_nan, n_inf, _ = counts.tolist()
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT and (n_nan or n_inf):
        raise FloatingPointError(
            f"check_numerics: {op_type or 'tensor'} {var_name!r} has "
            f"{n_nan} nan / {n_inf} inf")
    counts = counts.as_subclass(Tensor)
    return counts[0], counts[1], counts[2]


# the FLAGS_check_nan_inf value before each enable_tensor_checker
_prev_state: list = []


def _flag() -> bool:
    return bool(get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"])


def enable_tensor_checker(checker_config: TensorCheckerConfig = None):
    """Turn the per-op NaN/inf check on (see the module docstring)."""
    cfg = checker_config or TensorCheckerConfig()
    if not cfg.enable:
        _prev_state.append(_flag())
        return
    if cfg.debug_mode != DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise NotImplementedError(
            "the live tensor checker aborts on nan/inf; for count-only "
            "scans use check_numerics(tensor, debug_mode=CHECK_NAN_INF)")
    _prev_state.append(_flag())
    set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    """Restore the flag the matching :func:`enable_tensor_checker` found
    (off when there is none)."""
    set_flags({"FLAGS_check_nan_inf": _prev_state.pop() if _prev_state
               else False})


_op_stats_active = False


def enable_operator_stats_collection():
    """The reference's per-op dtype statistics: a stub, as in the JAX
    package (``torch.profiler`` gives per-op times on the card)."""
    global _op_stats_active
    _op_stats_active = True


def disable_operator_stats_collection():
    global _op_stats_active
    if _op_stats_active:
        print("<--- op dtype stats: see torch.profiler's key_averages --->")
    _op_stats_active = False
