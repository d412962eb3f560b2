"""Discrete distributions: the JAX package's six families."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dists.base import Distribution, register_dist

__all__ = ["Poisson", "Bernoulli", "BernoulliLogits", "Binomial",
           "Categorical", "DiscreteUniform"]


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
class Bernoulli(Distribution):
    probs: torch.Tensor = 0.5
    support = "binary"

    def log_prob(self, x):
        x = torch.as_tensor(x).to(self.dtype)
        p = torch.as_tensor(self.probs, dtype=self.dtype)
        return torch.xlogy(x, p) + torch.special.xlog1py(1.0 - x, -p)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        probs = torch.as_tensor(self.probs, dtype=self.dtype,
                                device=generator.device)
        u = torch.rand(shape, generator=generator, dtype=self.dtype,
                       device=generator.device)
        return (u < probs).to(torch.int32)

    def in_support(self, x):
        return torch.all((x == 0) | (x == 1))


@register_dist
class BernoulliLogits(Distribution):
    logits: torch.Tensor = 0.0
    support = "binary"

    def log_prob(self, x):
        # x*logits - softplus(logits), numerically stable
        logits = torch.as_tensor(self.logits, dtype=self.dtype)
        x = torch.as_tensor(x).to(self.dtype)
        return x * logits - F.softplus(logits)

    def total_log_prob(self, x):
        # the per-array kernel when the switch is on (kernels/__init__.py)
        import repro_torch.kernels as _k
        x = torch.as_tensor(x)
        if _k.fused_logpdf_enabled() and x.numel() >= 1024:
            logits = torch.as_tensor(self.logits, dtype=self.dtype)
            shape = torch.broadcast_shapes(logits.shape, x.shape)
            return _k.bernoulli_logits_logpmf_sum(
                logits.expand(shape).reshape(-1),
                x.to(self.dtype).expand(shape).reshape(-1))
        return torch.sum(self.log_prob(x))

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

    ``total_log_prob`` is the plain sum of ``log_prob`` unless the per-array
    switch is on (``kernels.use_fused_logpdf``); the fused evaluators send
    Categorical sites to the ``categorical_logits`` kernel themselves.
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

    def total_log_prob(self, x):
        import repro_torch.kernels as _k
        x = torch.as_tensor(x)
        logits = torch.as_tensor(self.logits, dtype=self.dtype)
        if (_k.fused_logpdf_enabled() and logits.dim() >= 2
                and x.numel() >= 256):
            c = logits.shape[-1]
            lead = torch.broadcast_shapes(logits.shape[:-1], x.shape)
            return _k.categorical_logits_logpmf_sum(
                logits.expand(lead + (c,)).reshape(-1, c),
                x.expand(lead).reshape(-1))
        return torch.sum(self.log_prob(x))

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


@register_dist
class Binomial(Distribution):
    total_count: torch.Tensor = 1
    probs: torch.Tensor = 0.5
    support = "nonnegative_int"

    def log_prob(self, x):
        n = torch.as_tensor(self.total_count).to(self.dtype)
        x = torch.as_tensor(x).to(self.dtype)
        p = torch.as_tensor(self.probs, dtype=self.dtype)
        log_comb = (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                    - torch.lgamma(n - x + 1.0))
        return (log_comb + torch.xlogy(x, p)
                + torch.special.xlog1py(n - x, -p))

    def sample(self, generator, sample_shape=()):
        # the count of n_max uniforms below p, the first total_count of them
        shape = tuple(sample_shape) + self.shape
        dev = generator.device
        n = torch.as_tensor(self.total_count, device=dev)
        n_max = int(n.max())
        u = torch.rand((n_max,) + shape, generator=generator,
                       dtype=self.dtype, device=dev)
        k = torch.arange(n_max, device=dev).reshape((n_max,) + (1,) * len(shape))
        hit = (u < torch.as_tensor(self.probs, dtype=self.dtype, device=dev)) \
            & (k < n)
        return hit.sum(0).to(torch.int32)

    def in_support(self, x):
        return torch.all((x >= 0) & (x <= self.total_count))


@register_dist
class DiscreteUniform(Distribution):
    low: torch.Tensor = 0
    high: torch.Tensor = 1  # inclusive
    support = "discrete"

    def log_prob(self, x):
        n = torch.as_tensor(self.high - self.low + 1).to(self.dtype)
        x = torch.as_tensor(x)
        lp = torch.zeros(x.shape, dtype=self.dtype, device=x.device) \
            - torch.log(n)
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, lp, -math.inf)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        dev = generator.device
        low = torch.as_tensor(self.low, device=dev)
        width = torch.as_tensor(self.high, device=dev) - low + 1
        u = torch.rand(shape, generator=generator, dtype=torch.float64,
                       device=dev)
        return (low + torch.floor(u * width).to(low.dtype)).to(torch.int32)

    def in_support(self, x):
        return torch.all((x >= self.low) & (x <= self.high))
