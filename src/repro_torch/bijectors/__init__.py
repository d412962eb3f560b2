"""repro_torch.bijectors — constrained <-> unconstrained transforms (Stan-style).

HMC operates on unconstrained reals. Each distribution's support maps to a
bijector; the log-density picks up the forward log-det-Jacobian:

    logp(x_unc) = logp_constrained(forward(x_unc)) + fldj(x_unc)

Conventions: ``forward``: unconstrained -> constrained;
``inverse``: constrained -> unconstrained; ``forward_log_det_jacobian``
returns the SCALAR sum over all elements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "Bijector", "Identity", "Exp", "Sigmoid", "Softplus", "StickBreaking",
    "Ordered", "Affine", "bijector_for", "unconstrained_shape",
]


def _as_like(v, x: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor of ``x``'s type and device; a Python number as a
    device fill, not a host-to-device copy (which a captured transition
    cannot hold)."""
    if not torch.is_tensor(v) and isinstance(v, (int, float)):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _stick_offset(km1: int, x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.arange(km1, 0, -1, dtype=x.dtype, device=x.device))


class _CumprodLast(torch.autograd.Function):
    """``torch.cumprod(x, -1)`` with the closed-form backward
    ``reverse_cumsum(g * out) / x``. Autograd's own cumprod backward guards
    against zeros in ``x``: eagerly with a device sync, and under
    ``torch.func`` with a loop of about three ops per element along the
    axis (99 elements per row for lda's phi). The stick-breaking factors
    ``1 - z`` are positive wherever the density is finite."""

    @staticmethod
    def forward(x):
        return torch.cumprod(x, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        tail = torch.flip(torch.cumsum(torch.flip(g * out, [-1]), dim=-1),
                          [-1])
        return tail / x

    @staticmethod
    def vmap(info, in_dims, x):
        return _CumprodLast.apply(x.movedim(in_dims[0], 0)), 0


class Bijector:
    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError

    def unconstrained_shape(self, constrained_shape):
        return tuple(constrained_shape)


class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)


class Exp(Bijector):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return torch.sum(x)


class Softplus(Bijector):
    def forward(self, x):
        return F.softplus(x)

    def inverse(self, y):
        # log(exp(y) - 1), stable: y + log1p(-exp(-y))
        return y + torch.log(-torch.expm1(-y))

    def forward_log_det_jacobian(self, x):
        return torch.sum(-F.softplus(-x))


class Sigmoid(Bijector):
    """Maps reals to (low, high)."""

    def __init__(self, low=0.0, high=1.0):
        self.low = low
        self.high = high

    def forward(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y):
        u = (y - self.low) / (self.high - self.low)
        return torch.log(u) - torch.log1p(-u)

    def forward_log_det_jacobian(self, x):
        width = torch.broadcast_to(_as_like(self.high - self.low, x), x.shape)
        # d/dx sigmoid = sigmoid(x) sigmoid(-x); log = -softplus(x)-softplus(-x)
        return torch.sum(torch.log(width) - F.softplus(x) - F.softplus(-x))


class Affine(Bijector):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale

    def forward(self, x):
        return self.loc + self.scale * x

    def inverse(self, y):
        return (y - self.loc) / self.scale

    def forward_log_det_jacobian(self, x):
        scale = torch.broadcast_to(_as_like(self.scale, x), x.shape)
        return torch.sum(torch.log(torch.abs(scale)))


class StickBreaking(Bijector):
    """R^{K-1} -> K-simplex (Stan's stick-breaking transform).

    Operates over the LAST axis; leading axes are batch.
    """

    def forward(self, x):
        z = torch.sigmoid(x - _stick_offset(x.shape[-1], x))
        one_minus = _CumprodLast.apply(1.0 - z)
        remainder = torch.cat(
            [torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], dim=-1)
        return torch.cat([z * remainder, one_minus[..., -1:]], dim=-1)

    def inverse(self, y):
        # The stick left before break k is the tail sum sum_{j>=k} y_j (a
        # reversed cumsum), not 1 - sum_{j<k} y_j: the tail sum has no
        # cancellation, so entries far below the float32 epsilon survive.
        # With z_k = y_k / tail_k and 1 - z_k = tail_{k+1} / tail_k, the
        # logit of z_k is log y_k - log tail_{k+1}.
        tail = torch.flip(torch.cumsum(torch.flip(y, [-1]), dim=-1), [-1])
        return (torch.log(y[..., :-1]) - torch.log(tail[..., 1:])
                + _stick_offset(y.shape[-1] - 1, y))

    def forward_log_det_jacobian(self, x):
        xs = x - _stick_offset(x.shape[-1], x)
        z = torch.sigmoid(xs)
        one_minus = _CumprodLast.apply(1.0 - z)
        remainder = torch.cat(
            [torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], dim=-1)
        # diag terms: remainder_k * z_k * (1 - z_k)
        log_diag = torch.log(remainder) - F.softplus(xs) - F.softplus(-xs)
        return torch.sum(log_diag)

    def unconstrained_shape(self, constrained_shape):
        s = tuple(constrained_shape)
        return s[:-1] + (s[-1] - 1,)


class Ordered(Bijector):
    """R^K -> ordered vectors: y1 = x1, y_k = y_{k-1} + exp(x_k)."""

    def forward(self, x):
        return torch.cumsum(torch.cat([x[..., :1], torch.exp(x[..., 1:])],
                                      dim=-1), dim=-1)

    def inverse(self, y):
        diffs = torch.log(y[..., 1:] - y[..., :-1])
        return torch.cat([y[..., :1], diffs], dim=-1)

    def forward_log_det_jacobian(self, x):
        return torch.sum(x[..., 1:])


_SUPPORT_TO_BIJECTOR = {
    "real": lambda d: Identity(),
    "positive": lambda d: Exp(),
    "unit_interval": lambda d: Sigmoid(0.0, 1.0),
    "interval": lambda d: Sigmoid(d.low, d.high),
    "simplex": lambda d: StickBreaking(),
    "ordered": lambda d: Ordered(),
}


def bijector_for(dist) -> Bijector:
    """Default bijector for a distribution's support (Stan-style)."""
    support = getattr(dist, "support", "real")
    if support in ("discrete", "nonnegative_int", "binary"):
        raise ValueError(
            f"distribution {type(dist).__name__} is discrete; it has no "
            "unconstraining bijector (marginalise it or use Gibbs/MH)."
        )
    return _SUPPORT_TO_BIJECTOR[support](dist)


def unconstrained_shape(dist, constrained_shape):
    return bijector_for(dist).unconstrained_shape(constrained_shape)

