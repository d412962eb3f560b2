"""SGLD / pSGLD — stochastic-gradient MCMC for minibatch models.

This is where the paper's MiniBatchContext (§3.1) earns its keep at scale:
the likelihood term of the log-joint is rescaled by N_total/batch so the
stochastic gradient is unbiased, and Langevin noise turns SGD into a
posterior sampler.

``SGLD.step`` is a plain function over (generator, params tree, grads,
state). The steps take a ``torch.Generator`` where ``repro``'s take a key.
They run on any model, the Bayesian LM included: its trunk's attention
and SSD kernels are ``torch.func``-ready autograd Functions. SGLD over
the LM's weights at scale is ``models.bayes_lm.make_train_step(mode=
"sgld")``, whose gradient is taken with ``torch.autograd`` (remat applies
there and not under ``torch.func``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.core.contexts import MiniBatchContext
from repro_torch.core.model import Model
from repro_torch.core.program import (CompiledProgram, ProgramKey,
                                      model_fingerprint, program_cache)

__all__ = ["SGLD", "make_sgld_step", "make_subsampled_sgld_step"]


@dataclasses.dataclass(frozen=True)
class SGLD:
    """(preconditioned) stochastic-gradient Langevin dynamics."""

    step_size: float = 1e-5
    precondition: bool = True  # RMSProp-style preconditioning (pSGLD)
    beta: float = 0.999
    eps: float = 1e-5
    temperature: float = 1.0  # 0.0 => plain SGD on the log-joint (MAP)

    def init(self, params):
        if not self.precondition:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def step(self, generator: torch.Generator, params, grads, state):
        """One SGLD update. grads = d logp / d params (ASCENT direction).
        Draws one float32 normal a leaf, in the tree's leaf order."""
        leaves, spec = tree_flatten(params)
        gleaves, _ = tree_flatten(grads)

        def normal(p):
            return torch.randn(p.shape, generator=generator,
                               dtype=torch.float32, device=p.device)

        if self.precondition:
            vleaves, _ = tree_flatten(state)
            new_v, new_p = [], []
            for p, g, v in zip(leaves, gleaves, vleaves):
                g32 = g.to(torch.float32)
                v = self.beta * v + (1.0 - self.beta) * torch.square(g32)
                m = 1.0 / (torch.sqrt(v) + self.eps)
                noise = torch.sqrt(2.0 * self.step_size * m
                                   * self.temperature) * normal(p)
                delta = self.step_size * m * g32 + noise
                new_p.append((p.to(torch.float32) + delta).to(p.dtype))
                new_v.append(v)
            return tree_unflatten(new_p, spec), tree_unflatten(new_v, spec)

        new_p = []
        for p, g in zip(leaves, gleaves):
            noise = math.sqrt(2.0 * self.step_size * self.temperature) \
                * normal(p)
            delta = self.step_size * g.to(torch.float32) + noise
            new_p.append((p.to(torch.float32) + delta).to(p.dtype))
        return tree_unflatten(new_p, spec), state


def _value_and_grad_logjoint(m: Model, batch, ctx, param_site: str,
                             backend: str, params):
    def logjoint(p):
        mm = m.bind(**batch)
        return mm.logp_with_context({param_site: p}, ctx, backend=backend)

    grads, logp = torch.func.grad_and_value(logjoint)(params)
    return logp, grads


def make_sgld_step(m: Model, scale: float, sgld: Optional[SGLD] = None,
                   param_site: str = "params",
                   backend: str = "fused") -> Callable:
    """Build an SGLD step over a model whose minibatch enters as bound
    data: ``step(generator, params, state, **batch) -> (params, state,
    logp_hat)``. ``scale`` = N_total / batch_size (MiniBatchContext);
    ``backend`` selects the log-joint evaluation path (fused flat-block
    kernels by default, per-site reference otherwise)."""
    sgld = sgld if sgld is not None else SGLD()
    ctx = MiniBatchContext(scale=scale)
    cache = program_cache()
    mfp = model_fingerprint(m)

    def raw_step(generator, params, state, batch):
        logp, grads = _value_and_grad_logjoint(m, batch, ctx, param_site,
                                               backend, params)
        params, state = sgld.step(generator, params, grads, state)
        return params, state, logp

    # one program for every call: it runs eagerly at any shape, and counts
    # each structural signature of (params, state, batch) as a retrace
    pkey = ProgramKey(mfp, "sgld_step", None, (), backend,
                      (float(scale), sgld, param_site))
    prog = cache.get_or_build(pkey, lambda: CompiledProgram(pkey, raw_step))

    def step(generator, params, state, **batch):
        return prog(generator, params, state, batch)

    return step


def make_subsampled_sgld_step(m: Model, minibatch,
                              sgld: Optional[SGLD] = None,
                              param_site: str = "params",
                              backend: str = "fused") -> Callable:
    """SGLD step with the minibatch drawn INSIDE the step (self-batching).

    ``make_sgld_step`` expects the caller to hand it a batch; this
    variant owns the subsampling instead: each call first draws a
    without-replacement ``minibatch.batch_size``-row sample of the bound
    ``minibatch.sites`` arrays, then the Langevin noise, both from the
    step's generator, and evaluates the scaled-likelihood log-joint under
    ``MiniBatchContext(scale=N/B)`` — the estimator of
    :mod:`repro_torch.sharding.minibatch`, so the stochastic gradient is
    unbiased for the full-data log-joint.

    ``minibatch`` is a :class:`repro_torch.sharding.Minibatch`. The
    returned ``step(generator, params, state) -> (params, state,
    logp_hat)`` is one cached program (kind ``"sgld_step"``, subsampled
    flavour).
    """
    from repro_torch.sharding.minibatch import (Minibatch, draw_indices,
                                                full_data)

    if not isinstance(minibatch, Minibatch):
        raise TypeError("minibatch must be a repro_torch.sharding.Minibatch, "
                        f"got {type(minibatch).__name__}")
    sgld = sgld if sgld is not None else SGLD()
    full, n_total = full_data(m, minibatch)
    device = next(iter(full.values())).device
    ctx = MiniBatchContext(scale=n_total / minibatch.batch_size)
    cache = program_cache()
    mfp = model_fingerprint(m)

    def raw_step(generator, params, state):
        idx = draw_indices(generator, n_total, minibatch.batch_size, device)
        batch = {s: torch.index_select(v, 0, idx) for s, v in full.items()}
        logp, grads = _value_and_grad_logjoint(m, batch, ctx, param_site,
                                               backend, params)
        params, state = sgld.step(generator, params, grads, state)
        return params, state, logp

    pkey = ProgramKey(mfp, "sgld_step", None, (), backend,
                      ("subsampled", minibatch.fingerprint(), sgld,
                       param_site))
    return cache.get_or_build(pkey, lambda: CompiledProgram(pkey, raw_step))
