"""``paddle.nn`` of the port (counterpart of ``paddle_tpu/nn/``):
``Layer``, the layer families (activations, common, convolutions,
norms, pools, losses, recurrent, Transformer, the extras tail), the
clips, ``functional``, ``initializer`` and ``utils``, with Paddle's
layouts and semantics.
"""
from __future__ import annotations

from . import functional, initializer, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer.activation import *  # noqa: F401,F403
from .layer.activation import __all__ as _activation
from .layer.common import *  # noqa: F401,F403
from .layer.common import __all__ as _common
from .layer.conv import *  # noqa: F401,F403
from .layer.conv import __all__ as _conv
from .layer.extras import *  # noqa: F401,F403
from .layer.extras import __all__ as _extras
from .layer.layers import (Layer, Parameter, create_parameter,
                           layer_state_from_jax)
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                         KLDivLoss, L1Loss, MarginRankingLoss, MSELoss,
                         NLLLoss, SmoothL1Loss)
from .layer.norm import *  # noqa: F401,F403
from .layer.norm import __all__ as _norm
from .layer.pooling import *  # noqa: F401,F403
from .layer.pooling import __all__ as _pooling
from .layer.rnn import *  # noqa: F401,F403
from .layer.rnn import __all__ as _rnn
from .layer.transformer import *  # noqa: F401,F403
from .layer.transformer import __all__ as _transformer
from .utils import ParamAttr

__all__ = ["Layer", "Parameter", "create_parameter", "layer_state_from_jax",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "CrossEntropyLoss", "MSELoss", "L1Loss",
           "SmoothL1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss",
           "KLDivLoss", "MarginRankingLoss", "ParamAttr", "functional",
           "initializer", "utils", *_activation, *_common, *_conv, *_norm,
           *_pooling, *_rnn, *_transformer, *_extras]
