"""Discrete distributions. This slice ports ``BernoulliLogits``; the other
five discrete families of the JAX package are listed in ROADMAP.md."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["BernoulliLogits"]


@register_dist
class BernoulliLogits(Distribution):
    logits: torch.Tensor = 0.0
    support = "binary"

    def log_prob(self, x):
        # x*logits - softplus(logits), numerically stable
        logits = torch.as_tensor(self.logits, dtype=self.dtype)
        x = torch.as_tensor(x).to(self.dtype)
        return x * logits - F.softplus(logits)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        probs = torch.sigmoid(torch.as_tensor(self.logits, dtype=self.dtype,
                                              device=generator.device))
        u = torch.rand(shape, generator=generator, dtype=self.dtype,
                       device=generator.device)
        return (u < probs).to(torch.int32)

    def in_support(self, x):
        return torch.all((x == 0) | (x == 1))
