"""Subsampled (minibatch) log-density — unbiased stochastic estimator.

The estimator behind minibatch SGLD and stochastic ADVI: draw a
without-replacement index set ``S`` of size ``B`` from the ``N`` total
observations, bind only those rows, and evaluate the fused log-joint
under ``MiniBatchContext(scale=N/B)`` — prior once, likelihood scaled:

    L_hat(q; S) = prior(q) + (N/B) * sum_{i in S} loglik_i(q)

Uniform subsets give ``E_S[L_hat] = prior + likelihood`` exactly (each
row appears in a size-B subset with probability B/N). The API splits
generator-driven draws (``logdensity(q, generator)``) from explicit index
sets (``logdensity_at_indices(q, idx)``) so that the enumeration is
testable without touching the generator path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.contexts import MiniBatchContext

__all__ = ["Minibatch", "MinibatchLogDensity", "make_minibatch_logdensity"]


@dataclasses.dataclass(frozen=True)
class Minibatch:
    """Subsampling spec: which bound arrays to subsample, and how many rows.

    All ``sites`` must share one leading (observation) dimension — the
    same index draw slices every one of them, keeping paired arrays
    (features/labels, obs/groups) aligned.
    """

    sites: Tuple[str, ...]
    batch_size: int

    def __post_init__(self):
        object.__setattr__(self, "sites",
                           tuple(str(s) for s in self.sites))
        if not self.sites:
            raise ValueError("Minibatch.sites must name at least one "
                             "bound data array")
        if int(self.batch_size) < 1:
            raise ValueError("Minibatch.batch_size must be >= 1")
        object.__setattr__(self, "batch_size", int(self.batch_size))

    def fingerprint(self) -> Tuple:
        return ("minibatch", self.sites, self.batch_size)


def full_data(model, minibatch: Minibatch):
    """The subsampled sites' bound arrays as tensors on their device, and
    their shared leading dim N; raises on a missing site, a scalar or
    unequal leading dims."""
    full, ns = {}, []
    for site in minibatch.sites:
        if site not in model.data:
            raise ValueError(
                f"minibatch site '{site}' is not bound data of model "
                f"'{model.name}' (bound: {sorted(model.data)})")
        arr = torch.as_tensor(model.data[site])
        if arr.dim() < 1:
            raise ValueError(f"minibatch site '{site}' is a scalar; "
                             "subsampling slices the leading axis")
        full[site] = arr
        ns.append(int(arr.shape[0]))
    if len(set(ns)) != 1:
        raise ValueError(
            f"minibatch sites {list(minibatch.sites)} have unequal "
            f"leading dims {ns}; one index draw must slice all of them")
    return full, ns[0]


def draw_indices(generator: torch.Generator, num_total: int,
                 batch_size: int, device) -> torch.Tensor:
    """One without-replacement draw of ``batch_size`` of ``num_total`` row
    indices: the head of one ``torch.randperm``."""
    return torch.randperm(num_total, generator=generator,
                          device=device)[:batch_size]


class MinibatchLogDensity:
    """Callable pair over the flat unconstrained buffer (see module doc).

    Attributes
    ----------
    num_total : int
        N, the shared leading dim of the subsampled sites.
    scale : float
        N / batch_size, the likelihood reweighting factor.
    """

    def __init__(self, model, tvi_linked, minibatch: Minibatch, *,
                 backend: str = "fused"):
        self.minibatch = minibatch
        self.backend = backend
        self._model = model
        self._tvi = tvi_linked
        self._full, self.num_total = full_data(model, minibatch)
        if minibatch.batch_size > self.num_total:
            raise ValueError(
                f"batch_size {minibatch.batch_size} exceeds the "
                f"{self.num_total} available observations")
        self.scale = self.num_total / minibatch.batch_size
        self._ctx = MiniBatchContext(scale=self.scale)
        self._device = next(iter(self._full.values())).device

    def logdensity_at_indices(self, flat_u, idx):
        """Estimator at an EXPLICIT index set ``idx`` (B,) int tensor."""
        idx = torch.as_tensor(idx, device=self._device)
        batch = {s: torch.index_select(v, 0, idx)
                 for s, v in self._full.items()}
        mm = self._model.bind(**batch)
        tvi_q = self._tvi.replace_flat(flat_u)
        return mm.logp_with_context(tvi_q, self._ctx, backend=self.backend)

    def draw_indices(self, generator: torch.Generator) -> torch.Tensor:
        """One without-replacement index draw of ``batch_size`` rows."""
        return draw_indices(generator, self.num_total,
                            self.minibatch.batch_size, self._device)

    def logdensity(self, flat_u, generator: torch.Generator):
        """Estimator at a generator-driven index draw (one per call/step)."""
        return self.logdensity_at_indices(flat_u,
                                          self.draw_indices(generator))

    def __call__(self, flat_u, generator: torch.Generator):
        return self.logdensity(flat_u, generator)


def make_minibatch_logdensity(model, tvi_linked, minibatch: Minibatch, *,
                              backend: str = "fused") -> MinibatchLogDensity:
    """Build the subsampled estimator for a bound model + linked trace."""
    return MinibatchLogDensity(model, tvi_linked, minibatch, backend=backend)
