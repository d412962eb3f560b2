"""Univariate continuous distributions: the JAX package's 15 families."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dists.base import Distribution, register_dist

__all__ = [
    "Normal", "LogNormal", "HalfNormal", "Cauchy", "HalfCauchy", "StudentT",
    "Uniform", "Beta", "Gamma", "InverseGamma", "Exponential", "Laplace",
    "TruncatedNormal", "Flat", "LogisticDist",
]

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def _t(v) -> torch.Tensor:
    """A parameter as a float32 tensor (a Python number becomes a CPU
    scalar, which joins device tensors without a copy)."""
    return torch.as_tensor(v, dtype=torch.float32)


def _on(v, generator: torch.Generator) -> torch.Tensor:
    """A parameter as a float32 tensor on the generator's device."""
    return torch.as_tensor(v, dtype=torch.float32, device=generator.device)


def _randn(shape, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def _rand(shape, generator):
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


def _std_gamma(a: torch.Tensor, shape, generator) -> torch.Tensor:
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=generator)


def _cauchy(shape, generator):
    return torch.empty(shape, dtype=torch.float32,
                       device=generator.device).cauchy_(generator=generator)


@register_dist
class Normal(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "real"

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(_t(self.scale)) - 0.5 * _LOG_2PI

    def total_log_prob(self, x):
        # the per-array kernel when the switch is on (kernels/__init__.py)
        import repro_torch.kernels as _k
        x = torch.as_tensor(x)
        if _k.fused_logpdf_enabled() and x.numel() >= 1024:
            shape = torch.broadcast_shapes(
                x.shape, *(v.shape for v in (self.loc, self.scale)
                           if torch.is_tensor(v)))

            def flat(v):
                if not torch.is_tensor(v) or v.dim() == 0:
                    return v
                return v.expand(shape).reshape(-1)
            return _k.normal_logpdf_sum(flat(x), flat(self.loc),
                                        flat(self.scale))
        return torch.sum(self.log_prob(x))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return self.loc + self.scale * _randn(shape, generator)


@register_dist
class LogNormal(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "positive"

    def log_prob(self, x):
        lx = torch.log(_t(x))
        z = (lx - self.loc) / self.scale
        return -0.5 * z * z - torch.log(_t(self.scale)) - 0.5 * _LOG_2PI - lx

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return torch.exp(_on(self.loc, generator)
                         + _on(self.scale, generator) * _randn(shape, generator))

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class HalfNormal(Distribution):
    scale: torch.Tensor = 1.0
    support = "positive"

    def log_prob(self, x):
        z = x / self.scale
        return (-0.5 * z * z - torch.log(_t(self.scale)) - 0.5 * _LOG_2PI
                + _LOG_2)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return torch.abs(_on(self.scale, generator) * _randn(shape, generator))

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class Cauchy(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "real"

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -torch.log(math.pi * _t(self.scale) * (1.0 + z * z))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return (_on(self.loc, generator)
                + _on(self.scale, generator) * _cauchy(shape, generator))


@register_dist
class HalfCauchy(Distribution):
    scale: torch.Tensor = 1.0
    support = "positive"

    def log_prob(self, x):
        z = x / self.scale
        return _LOG_2 - torch.log(math.pi * _t(self.scale) * (1.0 + z * z))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return torch.abs(_on(self.scale, generator)
                         * _cauchy(shape, generator))

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class StudentT(Distribution):
    df: torch.Tensor = 1.0
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "real"

    def log_prob(self, x):
        df = _t(self.df)
        z = (x - self.loc) / self.scale
        return (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                - 0.5 * torch.log(df * math.pi) - torch.log(_t(self.scale))
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))

    def sample(self, generator, sample_shape=()):
        # z / sqrt(chi2_df / df), chi2_df = 2 Gamma(df / 2)
        shape = tuple(sample_shape) + self.shape
        df = _on(self.df, generator)
        chi2 = 2.0 * _std_gamma(0.5 * df, shape, generator)
        t = _randn(shape, generator) * torch.rsqrt(chi2 / df)
        return _on(self.loc, generator) + _on(self.scale, generator) * t


@register_dist
class Uniform(Distribution):
    low: torch.Tensor = 0.0
    high: torch.Tensor = 1.0
    support = "interval"

    def log_prob(self, x):
        # the constant joins x's shape (and device) before the select
        lp = torch.zeros_like(_t(x)) - torch.log(_t(self.high - self.low))
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, lp, -math.inf)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        low, high = _on(self.low, generator), _on(self.high, generator)
        return low + (high - low) * _rand(shape, generator)

    def in_support(self, x):
        return torch.all((x >= self.low) & (x <= self.high))


@register_dist
class Beta(Distribution):
    concentration1: torch.Tensor = 1.0  # alpha
    concentration0: torch.Tensor = 1.0  # beta
    support = "unit_interval"

    def log_prob(self, x):
        a, b = _t(self.concentration1), _t(self.concentration0)
        return (torch.xlogy(a - 1.0, x) + torch.special.xlog1py(b - 1.0, -x)
                + torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b))

    def sample(self, generator, sample_shape=()):
        # X / (X + Y) with X ~ Gamma(a), Y ~ Gamma(b)
        shape = tuple(sample_shape) + self.shape
        ga = _std_gamma(_on(self.concentration1, generator), shape, generator)
        gb = _std_gamma(_on(self.concentration0, generator), shape, generator)
        return ga / (ga + gb)

    def in_support(self, x):
        return torch.all((x > 0) & (x < 1))


@register_dist
class Gamma(Distribution):
    concentration: torch.Tensor = 1.0
    rate: torch.Tensor = 1.0
    support = "positive"

    def log_prob(self, x):
        a, b = _t(self.concentration), _t(self.rate)
        return (torch.xlogy(a, b) + torch.xlogy(a - 1.0, x) - b * x
                - torch.lgamma(a))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        g = _std_gamma(_on(self.concentration, generator), shape, generator)
        return g / _on(self.rate, generator)

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class InverseGamma(Distribution):
    concentration: torch.Tensor = 1.0
    rate: torch.Tensor = 1.0  # aka scale of the reciprocal
    support = "positive"

    def log_prob(self, x):
        a, b = _t(self.concentration), _t(self.rate)
        return (torch.xlogy(a, b) - (a + 1.0) * torch.log(_t(x)) - b / x
                - torch.lgamma(a))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        g = _std_gamma(_on(self.concentration, generator), shape, generator)
        return _on(self.rate, generator) / g

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class Exponential(Distribution):
    rate: torch.Tensor = 1.0
    support = "positive"

    def log_prob(self, x):
        return torch.log(_t(self.rate)) - self.rate * x

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        e = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return e.exponential_(generator=generator) / _on(self.rate, generator)

    def in_support(self, x):
        return torch.all(x > 0)


@register_dist
class Laplace(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "real"

    def log_prob(self, x):
        return (-torch.abs(x - self.loc) / self.scale
                - torch.log(2.0 * _t(self.scale)))

    def sample(self, generator, sample_shape=()):
        # inverse CDF of u - 1/2, u ~ U(0, 1)
        shape = tuple(sample_shape) + self.shape
        u = _rand(shape, generator) - 0.5
        lap = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
        return _on(self.loc, generator) + _on(self.scale, generator) * lap


@register_dist
class LogisticDist(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    support = "real"

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -z - 2.0 * F.softplus(-z) - torch.log(_t(self.scale))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        u = _rand(shape, generator)
        return (_on(self.loc, generator) + _on(self.scale, generator)
                * (torch.log(u) - torch.log1p(-u)))


def _std_normal_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


@register_dist
class TruncatedNormal(Distribution):
    loc: torch.Tensor = 0.0
    scale: torch.Tensor = 1.0
    low: torch.Tensor = -1.0
    high: torch.Tensor = 1.0
    support = "interval"

    def log_prob(self, x):
        a = _t((self.low - self.loc) / self.scale)
        b = _t((self.high - self.loc) / self.scale)
        z = (x - self.loc) / self.scale
        log_norm = torch.log(_std_normal_cdf(b) - _std_normal_cdf(a))
        base = -0.5 * z * z - torch.log(_t(self.scale)) - 0.5 * _LOG_2PI
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, base - log_norm, -math.inf)

    def sample(self, generator, sample_shape=()):
        # inverse CDF between the standardised bounds
        shape = tuple(sample_shape) + self.shape
        loc, scale = _on(self.loc, generator), _on(self.scale, generator)
        ca = _std_normal_cdf((_on(self.low, generator) - loc) / scale)
        cb = _std_normal_cdf((_on(self.high, generator) - loc) / scale)
        u = ca + (cb - ca) * _rand(shape, generator)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return torch.clamp(loc + scale * z, _on(self.low, generator),
                           _on(self.high, generator))

    def in_support(self, x):
        return torch.all((x >= self.low) & (x <= self.high))


@register_dist
class Flat(Distribution):
    """Improper flat prior on the reals: log p = 0 everywhere."""

    shape_hint: torch.Tensor = 0.0  # array whose shape defines the RV's shape
    support = "real"

    def log_prob(self, x):
        return torch.zeros_like(torch.as_tensor(x), dtype=self.dtype)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        return _randn(shape, generator)  # arbitrary init draw
