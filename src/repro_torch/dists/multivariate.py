"""Multivariate distributions: the JAX package's five families."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dists.base import Distribution, param_shape, register_dist

__all__ = ["MvNormal", "MvNormalDiag", "Dirichlet", "Multinomial",
           "MixtureSameFamily"]

_LOG_2PI = math.log(2.0 * math.pi)


@register_dist
class MvNormal(Distribution):
    """Dense multivariate Normal parameterised by a Cholesky factor.

    ``scale_tril`` is the lower-triangular L with covariance ``L L^T``.
    Batched ``x (..., D)`` against one unbatched ``L (D, D)`` is the layout
    the fused evaluator's dense-precision kernel takes; a batched factor
    runs per site.
    """

    loc: torch.Tensor = None
    scale_tril: torch.Tensor = None
    event_ndims = 1
    support = "real"

    # the base class strips event_ndims dims from every parameter, which
    # mangles the (D, D) factor: both shapes are overridden
    @property
    def batch_shape(self):
        loc = param_shape(self.loc)
        return tuple(np.broadcast_shapes(loc[:-1] if loc else (),
                                         param_shape(self.scale_tril)[:-2]))

    @property
    def event_shape(self):
        return (param_shape(self.scale_tril)[-1],)

    def log_prob(self, x):
        tril = torch.as_tensor(self.scale_tril, dtype=self.dtype)
        d = tril.shape[-1]
        xc = torch.as_tensor(x) - self.loc
        b = xc.unsqueeze(-1)
        a = torch.broadcast_to(tril, b.shape[:-2] + tril.shape[-2:])
        z = torch.linalg.solve_triangular(a, b, upper=False).squeeze(-1)
        half_logdet = torch.sum(torch.log(torch.diagonal(
            tril, dim1=-2, dim2=-1)), dim=-1)
        return (-0.5 * torch.sum(z * z, dim=-1) - half_logdet
                - 0.5 * d * _LOG_2PI)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.shape
        eps = torch.randn(shape, generator=generator, dtype=self.dtype,
                          device=generator.device)
        tril = torch.as_tensor(self.scale_tril, dtype=self.dtype,
                               device=generator.device)
        return self.loc + torch.einsum("...ij,...j->...i", tril, eps)


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


@register_dist
class Multinomial(Distribution):
    total_count: torch.Tensor = 1
    probs: torch.Tensor = None
    event_ndims = 1
    support = "nonnegative_int"

    def log_prob(self, x):
        x = torch.as_tensor(x).to(self.dtype)
        n = torch.as_tensor(self.total_count).to(self.dtype)
        probs = torch.as_tensor(self.probs, dtype=self.dtype)
        log_coef = torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0),
                                                     dim=-1)
        return log_coef + torch.sum(torch.xlogy(x, probs), dim=-1)

    def sample(self, generator, sample_shape=()):
        # counts of total_count categorical draws
        n = int(self.total_count)
        probs = torch.as_tensor(self.probs, dtype=self.dtype,
                                device=generator.device)
        k = probs.shape[-1]
        s = math.prod(sample_shape)
        idx = torch.multinomial(probs.reshape(-1, k), n * s, replacement=True,
                                generator=generator)  # (batch, n * s)
        counts = torch.nn.functional.one_hot(idx.reshape(-1, s, n), k).sum(-2)
        counts = counts.transpose(0, 1).reshape(
            tuple(sample_shape) + tuple(probs.shape[:-1]) + (k,))
        return counts.to(torch.int32)


@register_dist
class MixtureSameFamily(Distribution):
    """Finite mixture: ``mixing_logits (..., K)`` over the components of
    ``components``, a Distribution whose last batch axis is the mixture
    axis; ``log_prob(x) = logsumexp(log_softmax(mixing_logits) +
    components.log_prob(x[..., None]))``."""

    mixing_logits: torch.Tensor = None
    components: Distribution = None

    @property
    def batch_shape(self):
        # as the JAX package's: every parameter leaf, the components' too
        shapes = [param_shape(self.mixing_logits)] + \
            self.components._param_shapes()
        return tuple(np.broadcast_shapes(*shapes))

    def log_prob(self, x):
        comp_lp = self.components.log_prob(torch.as_tensor(x).unsqueeze(-1))
        mix_lp = torch.log_softmax(torch.as_tensor(
            self.mixing_logits, dtype=self.dtype), dim=-1)
        return torch.logsumexp(mix_lp + comp_lp, dim=-1)

    def sample(self, generator, sample_shape=()):
        logits = torch.as_tensor(self.mixing_logits, dtype=self.dtype,
                                 device=generator.device)
        k = logits.shape[-1]
        s = math.prod(sample_shape)
        idx = torch.multinomial(torch.softmax(logits, -1).reshape(-1, k), s,
                                replacement=True, generator=generator)
        idx = idx.t().reshape(tuple(sample_shape) + tuple(logits.shape[:-1]))
        draws = self.components.sample(generator, tuple(sample_shape))
        idx = torch.broadcast_to(idx.unsqueeze(-1), draws.shape[:-1] + (1,))
        return torch.gather(draws, -1, idx).squeeze(-1)
