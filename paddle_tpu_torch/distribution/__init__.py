"""``paddle.distribution``: probability distributions, bijective
transforms and the KL registry.

Counterpart of ``paddle_tpu/distribution``: every density, entropy and
KL a function of torch tensors on their device, the draws on the JAX
package's threefry keys (``distribution.py`` says which draws match it
bit for bit and which do not).
"""
from .distribution import Distribution, ExponentialFamily
from .continuous import (Beta, Dirichlet, Exponential, Gumbel, Laplace,
                         LogNormal, Normal, Uniform)
from .discrete import Bernoulli, Categorical, Multinomial
from .transformed_distribution import Independent, TransformedDistribution
from .transform import (AbsTransform, AffineTransform, ChainTransform,
                        ExpTransform, IndependentTransform, PowerTransform,
                        ReshapeTransform, SigmoidTransform, SoftmaxTransform,
                        StackTransform, StickBreakingTransform,
                        TanhTransform, Transform)
from .kl import kl_divergence, register_kl

__all__ = [
    "Distribution", "ExponentialFamily",
    "Normal", "Uniform", "Beta", "Dirichlet", "Categorical", "Multinomial",
    "Gumbel", "Laplace", "LogNormal", "Exponential", "Bernoulli",
    "Independent", "TransformedDistribution",
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform",
    "kl_divergence", "register_kl",
]
