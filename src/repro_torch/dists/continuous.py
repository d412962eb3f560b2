"""Univariate continuous distributions. This slice ports ``Normal``; the
other 14 continuous families of the JAX package are listed in ROADMAP.md."""
from __future__ import annotations

import math

import torch

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["Normal"]

_LOG_2PI = math.log(2.0 * math.pi)


@register_dist
class Normal(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "real"

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return (-0.5 * z * z - torch.log(torch.as_tensor(self.scale))
                - 0.5 * _LOG_2PI)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        eps = torch.randn(shape, generator=generator, dtype=self.dtype,
                          device=generator.device)
        return self.loc + self.scale * eps
