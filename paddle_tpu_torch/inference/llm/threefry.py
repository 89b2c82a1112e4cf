"""The serving engine's threefry sampling functions: the port's
Threefry-2x32 lives in ``paddle_tpu_torch/core/threefry.py`` (the core
does not depend on the engine); this module keeps the engine's import
path."""
from ...core.threefry import (categorical, fold_in, gumbel, prng_key,
                              random_bits, threefry2x32, uniform)

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]
