"""PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package serves the same
decoder-only LM through the same serving entry points, and trains the
GPT family through the same training entry points (``text.gpt``,
``optimizer``, ``amp``, ``jit.TrainStep``), on an NVIDIA GPU, with the
TPU's Pallas kernels rewritten by hand for Hopper (``kernels/csrc``).
It imports ``torch`` and never ``jax`` or anything of ``paddle_tpu``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
