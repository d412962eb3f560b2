"""Plain PyTorch versions of the fused logpdf kernels.

Each reduces over the LAST axis: a 1-D input gives a scalar (the JAX
package's ``ref.py`` contract), a ``(B, n)`` input gives ``(B,)`` (the
kernels' row layout). The CPU path of every wrapper in ``ops.py`` runs
these, and ``chip_smoke.py`` holds each CUDA kernel against them.
``categorical_logits_logpmf_sum_ref`` reduces the item axis in front of the
class axis: ``(N, C)`` logits give a scalar, ``(B, N, C)`` give ``(B,)``;
``mvnormal_prec_quadform_sum_ref`` reduces the last two axes of
``xc (..., N, D)``. The elementwise ones broadcast their inputs first.
"""
from __future__ import annotations

import math

import torch

__all__ = ["std_normal_logpdf_sum_ref", "normal_logpdf_sum_ref",
           "bernoulli_logits_logpmf_sum_ref",
           "categorical_logits_logpmf_sum_ref", "gamma_unnorm_logpdf_sum_ref",
           "beta_unnorm_logpdf_sum_ref", "student_t_unnorm_logpdf_sum_ref",
           "mvnormal_prec_quadform_sum_ref"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def std_normal_logpdf_sum_ref(z: torch.Tensor) -> torch.Tensor:
    """``sum(-z^2/2 - log(2 pi)/2)`` over the last axis."""
    z = z.to(torch.float32)
    return torch.sum(-0.5 * z * z - _HALF_LOG_2PI, dim=-1)


def normal_logpdf_sum_ref(x: torch.Tensor, loc: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``sum(-z^2/2 - log scale - log(2 pi)/2)`` with ``z = (x - loc) /
    scale``, over the last axis."""
    scale = scale.to(torch.float32)
    z = (x.to(torch.float32) - loc.to(torch.float32)) / scale
    return torch.sum(-0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI, dim=-1)


def bernoulli_logits_logpmf_sum_ref(logits: torch.Tensor,
                                    y: torch.Tensor) -> torch.Tensor:
    """``sum(-softplus(-l) - (1 - y) l)`` over the last axis."""
    logits = logits.to(torch.float32)
    y = y.to(torch.float32)
    return torch.sum(-torch.logaddexp(torch.zeros_like(logits), -logits)
                     - (1.0 - y) * logits, dim=-1)


def categorical_logits_logpmf_sum_ref(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """``sum_n log_softmax(logits_n)[labels_n]`` over the item axis.

    ``logits (..., N, C)``; ``labels`` int, broadcastable to ``(..., N)``. A
    label outside ``[0, C)`` gives NaN (the JAX package's ``ref.py`` fills
    NaN above ``C`` and wraps negative labels as NumPy does; the port has
    no wrap-around)."""
    logits = logits.to(torch.float32)
    c = logits.shape[-1]
    labels = torch.broadcast_to(labels, logits.shape[:-1])
    valid = (labels >= 0) & (labels < c)
    idx = torch.where(valid, labels, 0).to(torch.int64)
    picked = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                          idx.unsqueeze(-1)).squeeze(-1)
    return torch.sum(torch.where(valid, picked, torch.nan), dim=-1)


def gamma_unnorm_logpdf_sum_ref(x: torch.Tensor, am1: torch.Tensor,
                                rate: torch.Tensor) -> torch.Tensor:
    """``sum((a - 1) log x - b x)`` over the last axis: the part of the
    Gamma log-density that depends on ``x`` (the ``a log b - lgamma(a)``
    normaliser stays with the caller)."""
    x = x.to(torch.float32)
    return torch.sum(am1.to(torch.float32) * torch.log(x)
                     - rate.to(torch.float32) * x, dim=-1)


def beta_unnorm_logpdf_sum_ref(x: torch.Tensor, am1: torch.Tensor,
                               bm1: torch.Tensor) -> torch.Tensor:
    """``sum((a - 1) log x + (b - 1) log1p(-x))`` over the last axis: the
    part of the Beta log-density that depends on ``x`` (the log-beta
    normaliser stays with the caller)."""
    x = x.to(torch.float32)
    return torch.sum(am1.to(torch.float32) * torch.log(x)
                     + bm1.to(torch.float32) * torch.log1p(-x), dim=-1)


def student_t_unnorm_logpdf_sum_ref(z: torch.Tensor,
                                    df: torch.Tensor) -> torch.Tensor:
    """``sum(-(df + 1)/2 log1p(z^2/df))`` over the last axis, on
    standardised ``z`` (the lgamma and log-scale normaliser stays with the
    caller)."""
    z = z.to(torch.float32)
    df = df.to(torch.float32)
    return torch.sum(-0.5 * (df + 1.0) * torch.log1p(z * z / df), dim=-1)


def mvnormal_prec_quadform_sum_ref(xc: torch.Tensor,
                                   prec: torch.Tensor) -> torch.Tensor:
    """``-1/2 sum_n xc_n^T P xc_n`` for centred rows ``xc (..., N, D)`` and
    a precision ``P (..., D, D)``: the dense-MvNormal part (the ``-N (log
    det L + D/2 log 2 pi)`` normaliser stays with the caller). Run with
    TF32 off, as every entry point of the port sets it."""
    xc = xc.to(torch.float32)
    return -0.5 * torch.sum(torch.matmul(xc, prec.to(torch.float32)) * xc,
                            dim=(-2, -1))
