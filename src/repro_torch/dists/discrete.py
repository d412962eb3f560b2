"""Discrete distributions. This slice ports ``Poisson``,
``BernoulliLogits`` and ``Categorical``; the other three discrete
families of the JAX package are listed in ROADMAP.md."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["Poisson", "BernoulliLogits", "Categorical"]


@register_dist
class Poisson(Distribution):
    rate: torch.Tensor = 1.0
    support = "nonnegative_int"

    def log_prob(self, x):
        x = torch.as_tensor(x).to(self.dtype)
        rate = torch.as_tensor(self.rate, dtype=self.dtype)
        return torch.xlogy(x, rate) - rate - torch.lgamma(x + 1.0)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        rate = torch.as_tensor(self.rate, dtype=self.dtype,
                               device=generator.device)
        draw = torch.poisson(rate.expand(shape).contiguous(),
                             generator=generator)
        return draw.to(torch.int32)

    def in_support(self, x):
        return torch.all(x >= 0)


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


@register_dist
class Categorical(Distribution):
    """Categorical over the last axis of ``logits``.

    ``total_log_prob`` stays the plain sum of ``log_prob``: the fused
    evaluators send Categorical sites to the ``categorical_logits`` kernel
    themselves, so an eager run (model discovery) launches nothing.
    """

    logits: torch.Tensor = None
    support = "discrete"
    event_ndims = 0  # value is an integer index; logits carry a trailing axis

    @property
    def num_categories(self):
        return self.logits.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.logits.shape[:-1])

    @property
    def event_shape(self):
        return ()

    @property
    def shape(self):
        return self.batch_shape

    def log_prob(self, x):
        logp = torch.log_softmax(torch.as_tensor(self.logits,
                                                 dtype=self.dtype), dim=-1)
        idx = torch.as_tensor(x).to(torch.int64)
        idx = torch.broadcast_to(idx, logp.shape[:-1])
        return torch.gather(logp, -1, idx.unsqueeze(-1)).squeeze(-1)

    def sample(self, generator, sample_shape=()):
        n = math.prod(sample_shape)
        c = self.num_categories
        probs = torch.softmax(torch.as_tensor(
            self.logits, dtype=self.dtype, device=generator.device), dim=-1)
        draws = torch.multinomial(probs.reshape(-1, c), n, replacement=True,
                                  generator=generator)  # (batch, n)
        draws = draws.t().reshape(tuple(sample_shape) + self.batch_shape)
        return draws.to(torch.int32)

    def in_support(self, x):
        return torch.all((x >= 0) & (x < self.num_categories))
