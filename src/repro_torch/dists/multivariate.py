"""Multivariate distributions. This slice ports ``MvNormalDiag`` and
``Dirichlet``; the other three multivariate families of the JAX package
are listed in ROADMAP.md."""
from __future__ import annotations

import math

import torch

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["MvNormalDiag", "Dirichlet"]

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


@register_dist
class Dirichlet(Distribution):
    """Dirichlet over the last axis of ``concentration``; leading axes are
    batch (one simplex per row)."""

    concentration: torch.Tensor = None
    event_ndims = 1
    support = "simplex"

    def log_prob(self, x):
        a = torch.as_tensor(self.concentration, dtype=self.dtype)
        norm = (torch.sum(torch.lgamma(a), dim=-1)
                - torch.lgamma(torch.sum(a, dim=-1)))
        return torch.sum(torch.xlogy(a - 1.0, x), dim=-1) - norm

    def sample(self, generator, sample_shape=()):
        # normalised Gamma(a_k, 1) draws
        shape = tuple(sample_shape) + self.shape
        a = torch.as_tensor(self.concentration, dtype=self.dtype,
                            device=generator.device)
        g = torch._standard_gamma(a.expand(shape).contiguous(),
                                  generator=generator)
        return g / torch.sum(g, dim=-1, keepdim=True)

    def in_support(self, x):
        row_ok = torch.all(x >= 0) & torch.all(x <= 1)
        sums = torch.sum(x, dim=-1)
        return row_ok & torch.all(torch.abs(sums - 1.0) < 1e-4)
