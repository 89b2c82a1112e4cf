"""Mixed precision of the port: ``decorate`` (O2), ``auto_cast`` (O1
and O2 per-op casts with the JAX package's lists) and ``GradScaler``."""
from .auto_cast import (amp_guard, amp_op_dtype, auto_cast, black_list,
                        decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["decorate", "auto_cast", "amp_guard", "amp_op_dtype",
           "white_list", "black_list", "GradScaler", "AmpScaler"]
