"""Distribution base class.

Distributions are frozen dataclasses so they can be stored inside traces
(VarInfo). Parameter fields hold tensors or Python numbers; static config
(e.g. event_ndims) lives on the class. Sampling takes an explicit
``torch.Generator`` and draws on that generator's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["Distribution", "register_dist", "param_shape"]


def param_shape(v) -> Tuple[int, ...]:
    """Shape of a parameter field (tensor, array or Python number)."""
    return tuple(v.shape) if torch.is_tensor(v) else tuple(np.shape(v))


class Distribution:
    """Base class for all distributions.

    Subclasses define parameter fields (dataclass), ``event_ndims`` (class
    attr), ``log_prob``, ``sample`` and ``support`` (a string tag consumed by
    ``repro_torch.bijectors.bijector_for``).
    """

    event_ndims: int = 0
    support: str = "real"  # real|positive|unit_interval|simplex|ordered|
    #                        interval|discrete|nonnegative_int|binary

    def _param_shapes(self):
        return [param_shape(getattr(self, f.name))
                for f in dataclasses.fields(self)]

    # -- shapes ------------------------------------------------------------
    @property
    def batch_shape(self) -> Tuple[int, ...]:
        shapes = []
        for s in self._param_shapes():
            if self.event_ndims:
                s = s[: len(s) - self.event_ndims] if len(s) >= self.event_ndims else ()
            shapes.append(s)
        if not shapes:
            return ()
        return tuple(np.broadcast_shapes(*shapes))

    @property
    def event_shape(self) -> Tuple[int, ...]:
        if self.event_ndims == 0:
            return ()
        for s in self._param_shapes():
            if len(s) >= self.event_ndims:
                return tuple(s[len(s) - self.event_ndims:])
        return ()

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.batch_shape) + tuple(self.event_shape)

    # -- core API ----------------------------------------------------------
    def log_prob(self, x) -> torch.Tensor:
        """Elementwise log density over the batch shape (events reduced)."""
        raise NotImplementedError

    def total_log_prob(self, x) -> torch.Tensor:
        """Scalar sum of ``log_prob`` over all batch dims."""
        return torch.sum(self.log_prob(x))

    def sample(self, generator: torch.Generator,
               sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError

    def in_support(self, x) -> torch.Tensor:
        """Boolean scalar: every element of x inside the support."""
        return torch.tensor(True)

    # -- misc ----------------------------------------------------------------
    @property
    def dtype(self):
        return torch.float32

    def __repr__(self) -> str:  # concise: Normal(loc=..., scale=...)
        fields = dataclasses.fields(self)
        args = ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in fields)
        return f"{type(self).__name__}({args})"


def register_dist(cls):
    """Decorator: make ``cls`` a frozen dataclass."""
    return dataclasses.dataclass(frozen=True, repr=False)(cls)
