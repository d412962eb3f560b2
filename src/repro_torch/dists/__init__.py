"""repro_torch.dists — the distribution families this slice of the port
needs (``Normal``, ``BernoulliLogits``, ``MvNormalDiag``)."""
from repro_torch.dists.base import Distribution, register_dist
from repro_torch.dists.continuous import Normal
from repro_torch.dists.discrete import BernoulliLogits
from repro_torch.dists.multivariate import MvNormalDiag

__all__ = ["Distribution", "register_dist", "Normal", "BernoulliLogits",
           "MvNormalDiag"]
