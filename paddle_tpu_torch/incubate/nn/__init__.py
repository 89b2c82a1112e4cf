"""``paddle.incubate.nn``: the fused layers and their functionals
(counterpart of ``paddle_tpu/incubate/nn/__init__.py``)."""
from . import functional  # noqa: F401
from .layer import (FusedBiasDropoutResidualLayerNorm,  # noqa: F401
                    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
                    FusedMultiTransformer, FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear", "FusedBiasDropoutResidualLayerNorm"]
