"""Multivariate distributions. This slice ports ``MvNormalDiag``; the other
four multivariate families of the JAX package are listed in ROADMAP.md."""
from __future__ import annotations

import math

import torch

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["MvNormalDiag"]

_LOG_2PI = math.log(2.0 * math.pi)


@register_dist
class MvNormalDiag(Distribution):
    loc: torch.Tensor = None
    scale_diag: torch.Tensor = None
    event_ndims = 1
    support = "real"

    def log_prob(self, x):
        z = (x - self.loc) / self.scale_diag
        return torch.sum(-0.5 * z * z - torch.log(self.scale_diag)
                         - 0.5 * _LOG_2PI, dim=-1)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        eps = torch.randn(shape, generator=generator, dtype=self.dtype,
                          device=generator.device)
        return self.loc + self.scale_diag * eps
