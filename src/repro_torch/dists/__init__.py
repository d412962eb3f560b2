"""repro_torch.dists — the distribution library of the PPL: the JAX
package's 26 families, with the same fields, support tags and densities."""
from repro_torch.dists.base import Distribution, register_dist
from repro_torch.dists.continuous import (
    Beta, Cauchy, Exponential, Flat, Gamma, HalfCauchy, HalfNormal,
    InverseGamma, Laplace, LogNormal, LogisticDist, Normal, StudentT,
    TruncatedNormal, Uniform,
)
from repro_torch.dists.discrete import (
    Bernoulli, BernoulliLogits, Binomial, Categorical, DiscreteUniform,
    Poisson,
)
from repro_torch.dists.multivariate import (
    Dirichlet, MixtureSameFamily, Multinomial, MvNormal, MvNormalDiag,
)

__all__ = [
    "Distribution", "register_dist",
    "Normal", "LogNormal", "HalfNormal", "Cauchy", "HalfCauchy", "StudentT",
    "Uniform", "Beta", "Gamma", "InverseGamma", "Exponential", "Laplace",
    "LogisticDist", "TruncatedNormal", "Flat",
    "Poisson", "Bernoulli", "BernoulliLogits", "Binomial", "Categorical",
    "DiscreteUniform",
    "MvNormal", "MvNormalDiag", "Dirichlet", "Multinomial",
    "MixtureSameFamily",
]
