"""Mean-field ADVI over the unconstrained space of a linked TypedVarInfo.

ELBO = E_q[logp(forward(u)) + log|detJ|] + H[q], estimated with K
reparameterised samples; optimised with the in-repo Adam
(``repro_torch.optim``). Supports ``minibatch=`` for stochastic
(minibatch) VI — the paper's §3.1 use case.

The gradient is ``torch.func.grad`` of a ``torch.func.vmap`` over the K
samples: the reverse of HMC's ``vmap(grad(...))``, so the fused
log-joint's ``torch.autograd.Function`` s (``kernels/fused_logpdf``) run
their ``vmap`` rule inside the gradient transform, and each density family
is one kernel launch for the K samples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.contexts import Context, DefaultContext
from repro_torch.core.model import Model
from repro_torch.core.program import (CompiledProgram, ProgramKey,
                                      density_program, model_fingerprint,
                                      program_cache)
from repro_torch.core.varinfo import TypedVarInfo, assert_continuous_supports
from repro_torch.optim import adam, apply_updates

__all__ = ["ADVI", "ADVIResult"]

_HALF_LOG_2PI_E = 0.5 * (1.0 + math.log(2.0 * math.pi))


@dataclasses.dataclass
class ADVIResult:
    mu: np.ndarray
    log_sigma: np.ndarray
    elbo_trace: np.ndarray
    tvi_linked: TypedVarInfo
    model: Model

    def sample(self, seed_or_generator, num_samples: int = 1000):
        """Posterior draws mapped back to constrained named tensors, each
        ``(num_samples,) + site.shape``, on the trace's device. Takes a
        ``torch.Generator`` (on that device) or an integer seed."""
        dev = self.tvi_linked.device
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        mu = torch.as_tensor(self.mu, device=dev)
        sigma = torch.exp(torch.as_tensor(self.log_sigma, device=dev))
        u = mu + sigma * torch.randn((num_samples, mu.shape[0]),
                                     generator=gen, device=dev)

        def to_constrained(q):
            return self.tvi_linked.replace_flat(q).invlink().as_dict()

        return torch.func.vmap(to_constrained)(u)


@dataclasses.dataclass
class ADVI:
    num_mc: int = 8
    lr: float = 0.05
    num_steps: int = 1000
    backend: str = "fused"  # log-density backend (see make_logdensity_fn)
    # subsampling spec (repro_torch.sharding.Minibatch): each optimisation
    # step draws ONE without-replacement index set and estimates the
    # ELBO's log-joint term with the scaled-likelihood minibatch density —
    # the index draw is shared across the num_mc reparameterised samples,
    # so one step touches batch_size rows instead of the full dataset
    minibatch: Optional[Any] = None

    def run(self, seed: int, m: Model, ctx: Optional[Context] = None,
            init_varinfo: Optional[TypedVarInfo] = None,
            device=None) -> ADVIResult:
        """Fit the mean-field Gaussian on ``device`` (``None`` means CUDA).

        One ``torch.Generator`` seeded with ``seed`` draws the discovery
        trace (when ``init_varinfo`` is absent) and then, each step, the
        ``(num_mc, dim)`` normals and (with ``minibatch=``) the index set,
        in that order.
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        tvi = (init_varinfo if init_varinfo is not None
               else m.typed_varinfo(gen))
        assert_continuous_supports(tvi, "ADVI")
        tvi = tvi.link()
        dim = int(tvi.num_flat)

        if self.minibatch is not None:
            if ctx is not None:
                raise ValueError(
                    "ADVI(minibatch=...) owns the evaluation context "
                    "(MiniBatchContext with scale=N/B); pass ctx=None")
            from repro_torch.sharding.minibatch import \
                make_minibatch_logdensity
            est = make_minibatch_logdensity(m, tvi, self.minibatch,
                                            backend=self.backend)

            def draws(generator):
                eps = torch.randn((self.num_mc, dim), generator=generator,
                                  device=dev)
                return eps, est.draw_indices(generator)

            def log_densities(u, idx):
                return torch.func.vmap(
                    lambda uu: est.logdensity_at_indices(uu, idx))(u)
        else:
            logdensity = density_program(m, tvi, ctx=ctx,
                                         backend=self.backend)

            def draws(generator):
                return (torch.randn((self.num_mc, dim), generator=generator,
                                    device=dev),)

            def log_densities(u):
                return torch.func.vmap(logdensity.raw)(u)

        def neg_elbo(params, eps, *idx):
            mu, log_sigma = params
            u = mu + torch.exp(log_sigma) * eps
            lps = log_densities(u, *idx)
            entropy = torch.sum(log_sigma) + dim * _HALF_LOG_2PI_E
            return -(torch.mean(lps) + entropy)

        opt = adam(self.lr)
        # Stan-style ADVI init: zero mean, unit-ish scale in UNCONSTRAINED space
        params = (torch.zeros((dim,), device=dev),
                  torch.full((dim,), -2.0, device=dev))
        state = opt.init(params)
        grad_and_loss = torch.func.grad_and_value(neg_elbo)

        def raw_step(params, state, generator):
            grads, loss = grad_and_loss(params, *draws(generator))
            deltas, state = opt.update(grads, state, params)
            return apply_updates(params, deltas), state, loss

        # The whole optimisation step, its draws included, is one cached
        # program: re-running ADVI on the same model/layout/hyperparameters
        # reuses the step, and on CUDA its graph.
        cache = program_cache()
        step_key = ProgramKey(
            model_fingerprint(m), "advi_step", tvi.layout, (),
            self.backend,
            (ctx if ctx is not None else DefaultContext(),
             int(self.num_mc), float(self.lr),
             self.minibatch.fingerprint()
             if self.minibatch is not None else ()))
        step = cache.get_or_build(
            step_key, lambda: CompiledProgram(step_key, raw_step))

        losses = []
        for _ in range(self.num_steps):
            params, state, loss = step(params, state, gen)
            losses.append(loss)
        mu, log_sigma = params
        elbos = -torch.stack(losses).cpu().numpy().astype(np.float32)
        return ADVIResult(mu.cpu().numpy(), log_sigma.cpu().numpy(),
                          elbos, tvi, m)
