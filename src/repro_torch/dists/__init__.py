"""repro_torch.dists — the distribution families ported so far
(``Normal``, ``Flat``, ``BernoulliLogits``, ``MvNormalDiag``)."""
from repro_torch.dists.base import Distribution, register_dist
from repro_torch.dists.continuous import Flat, Normal
from repro_torch.dists.discrete import BernoulliLogits
from repro_torch.dists.multivariate import MvNormalDiag

__all__ = ["Distribution", "register_dist", "Normal", "Flat",
           "BernoulliLogits", "MvNormalDiag"]
