"""Plain PyTorch versions of the fused logpdf kernels.

Each reduces over the LAST axis: a 1-D input gives a scalar (the JAX
package's ``ref.py`` contract), a ``(B, n)`` input gives ``(B,)`` (the
kernels' row layout). The CPU path of every wrapper in ``ops.py`` runs
these, and ``chip_smoke.py`` holds each CUDA kernel against them.
"""
from __future__ import annotations

import math

import torch

__all__ = ["std_normal_logpdf_sum_ref", "bernoulli_logits_logpmf_sum_ref"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def std_normal_logpdf_sum_ref(z: torch.Tensor) -> torch.Tensor:
    """``sum(-z^2/2 - log(2 pi)/2)`` over the last axis."""
    z = z.to(torch.float32)
    return torch.sum(-0.5 * z * z - _HALF_LOG_2PI, dim=-1)


def bernoulli_logits_logpmf_sum_ref(logits: torch.Tensor,
                                    y: torch.Tensor) -> torch.Tensor:
    """``sum(-softplus(-l) - (1 - y) l)`` over the last axis."""
    logits = logits.to(torch.float32)
    y = y.to(torch.float32)
    return torch.sum(-torch.logaddexp(torch.zeros_like(logits), -logits)
                     - (1.0 - y) * logits, dim=-1)
