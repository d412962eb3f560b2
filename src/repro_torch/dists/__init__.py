"""repro_torch.dists — the distribution families ported so far
(``Normal``, ``Gamma``, ``Flat``, ``Poisson``, ``BernoulliLogits``,
``Categorical``, ``MvNormalDiag``, ``Dirichlet``)."""
from repro_torch.dists.base import Distribution, register_dist
from repro_torch.dists.continuous import Flat, Gamma, Normal
from repro_torch.dists.discrete import BernoulliLogits, Categorical, Poisson
from repro_torch.dists.multivariate import Dirichlet, MvNormalDiag

__all__ = ["Distribution", "register_dist", "Normal", "Gamma", "Flat",
           "Poisson", "BernoulliLogits", "Categorical", "MvNormalDiag",
           "Dirichlet"]
