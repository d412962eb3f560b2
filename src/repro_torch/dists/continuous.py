"""Univariate continuous distributions. The port has ``Normal``,
``Gamma`` and ``Flat``; the other 12 continuous families of the JAX
package are listed in ROADMAP.md."""
from __future__ import annotations

import math

import torch

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["Normal", "Gamma", "Flat"]

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


@register_dist
class Gamma(Distribution):
    concentration: torch.Tensor = 1.0
    rate: torch.Tensor = 1.0
    support = "positive"

    def log_prob(self, x):
        a = torch.as_tensor(self.concentration, dtype=self.dtype)
        b = torch.as_tensor(self.rate, dtype=self.dtype)
        return (torch.xlogy(a, b) + torch.xlogy(a - 1.0, x) - b * x
                - torch.lgamma(a))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        dev = generator.device
        a = torch.as_tensor(self.concentration, dtype=self.dtype, device=dev)
        g = torch._standard_gamma(a.expand(shape).contiguous(),
                                  generator=generator)
        return g / torch.as_tensor(self.rate, dtype=self.dtype, device=dev)

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class Flat(Distribution):
    """Improper flat prior on the reals: log p = 0 everywhere."""

    shape_hint: torch.Tensor = 0.0  # array whose shape defines the RV's shape
    support = "real"

    def log_prob(self, x):
        return torch.zeros_like(torch.as_tensor(x), dtype=self.dtype)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return torch.randn(shape, generator=generator, dtype=self.dtype,
                           device=generator.device)  # arbitrary init draw
