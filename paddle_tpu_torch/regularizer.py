"""``paddle.regularizer``: the weight-decay policies an optimizer's
``weight_decay=`` takes (counterpart of ``paddle_tpu/regularizer.py``).

The optimizers read only the coefficient ``_coeff``
(``optimizer/optimizer.py`` ``_wd_value``). No rule reads ``L1Decay``'s
``_l1`` marker, in the JAX package or here, so ``L1Decay(c)`` decays as
``L2Decay(c)`` does: a reference quirk kept on purpose (ROADMAP queue
C).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._l1 = True

    def __repr__(self):
        return f"L1Decay({self._coeff})"
