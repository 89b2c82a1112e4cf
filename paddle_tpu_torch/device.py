"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means ``cuda``, and a machine without CUDA raises here
instead of quietly running the model on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is returned as a
    ``torch.device``. Raises ``RuntimeError`` when a CUDA device is
    asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path on "
            "the host")
    return dev
