"""Random-walk Metropolis–Hastings with early rejection (paper §3.3).

Two paths, like HMC:
* ``run``          — typed: every chain advances in lockstep through
  ``run_chains`` on the cached fused log-density (one kernel launch per
  density family per proposal, for all chains).
* ``run_untyped``  — eager: each proposal evaluates the model through the
  per-site evaluator with ``eager=True``; a ``reject()``/``reject_if()``
  in the model aborts the replay at once (a genuine compute shortcut, the
  paper's early rejection), counted in ``stats["n_early_rejected"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.contexts import DefaultContext
from repro_torch.core.model import Model
from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.infer.chains import (Chain, TransitionKernel, chain_draw,
                                      run_chains)
from repro_torch.infer.hmc import HMC

__all__ = ["RWMH"]


def _batched(logdensity):
    """``q -> logp`` for ``q (dim,)`` or a chain batch ``(num_chains, dim)``
    (under ``torch.func.vmap``). A log-density that carries its own batched
    ``value_and_grad`` (a data mesh's) batches itself."""
    if getattr(logdensity, "value_and_grad", None) is not None:
        return logdensity
    batched = torch.func.vmap(logdensity)
    return lambda q: logdensity(q) if q.dim() == 1 else batched(q)


@dataclasses.dataclass
class RWMH:
    """Gaussian random-walk MH in the unconstrained space."""

    proposal_scale: float = 0.1
    backend: str = "fused"  # log-density backend (see make_logdensity_fn)

    # -- TransitionKernel protocol (run_chains driver) -------------------------
    def make_kernel(self, logdensity, dim: int) -> TransitionKernel:
        """Build the RWMH :class:`TransitionKernel` for ``run_chains``.

        State is ``(q, logp)`` with the chain axis first; warmup
        transitions are plain MH steps (no adaptation); ``step`` emits
        ``{"q", "logp", "accept_prob", "diverging"}`` (``diverging``: the
        proposal's log-density came back NaN — for a gradient-free kernel
        that only happens when the density itself is broken, so it is
        surfaced as a health signal). Draws a transition: one normal
        ``q.shape`` proposal step, then one uniform per chain.
        """
        del dim  # the state shape is carried by q itself
        ld = _batched(logdensity)

        def init(q0):
            return (q0, ld(q0))

        def transition(state, generator):
            q, logp = state
            q_new = q + self.proposal_scale * chain_draw(
                torch.randn, q.shape, generator=generator, dtype=q.dtype,
                device=q.device)
            logp_new = ld(q_new)
            diverging = torch.isnan(logp_new)
            log_acc = torch.where(diverging, -torch.inf, logp_new - logp)
            u = chain_draw(torch.rand, logp.shape, generator=generator,
                           dtype=q.dtype, device=q.device)
            accept = torch.log(u) < log_acc
            q = torch.where(accept.unsqueeze(-1), q_new, q)
            logp = torch.where(accept, logp_new, logp)
            return (q, logp), (accept, diverging)

        def warm(state, t, generator):
            del t
            state, _ = transition(state, generator)
            return state

        def step(state, generator):
            state, (accept, diverging) = transition(state, generator)
            q, logp = state
            out = {"q": q, "logp": logp,
                   "accept_prob": accept.to(torch.float32),
                   "diverging": diverging}
            return state, out

        return TransitionKernel(init, warm, lambda s: s, step)

    def run(self, seed: int, m: Model, num_samples: int,
            num_warmup: int = 0,
            init_varinfo: Optional[TypedVarInfo] = None,
            num_chains: int = 1, device=None) -> Chain:
        """Sample ``num_chains`` chains of ``m`` on ``device`` (``None``
        means CUDA) through :func:`run_chains`, every chain from the
        discovery draw."""
        return run_chains(seed, m, self, num_samples, num_warmup=num_warmup,
                          num_chains=num_chains, init_varinfo=init_varinfo,
                          init_jitter=0.0, backend=self.backend,
                          device=device)

    def run_untyped(self, seed: int, m: Model, num_samples: int,
                    init_varinfo: Optional[TypedVarInfo] = None,
                    device=None) -> Chain:
        """Eager path — exercises early rejection as a real shortcut.

        One chain, a NumPy loop seeded from ``seed``
        (``np.random.default_rng``; the discovery draw, when
        ``init_varinfo`` is absent, from a ``torch.Generator`` seeded with
        ``seed``); every proposal replays the model eagerly on ``device``
        (``None`` means CUDA). A proposal whose replay hit ``reject()`` has
        log-density -inf and counts in ``stats["n_early_rejected"]``.
        """
        dev = resolve_device(device)
        tvi = (init_varinfo if init_varinfo is not None
               else m.typed_varinfo(
                   torch.Generator(device=dev).manual_seed(int(seed))))
        tvi = tvi.link()
        dim = int(tvi.num_flat)
        rng = np.random.default_rng(int(seed))
        ctx = DefaultContext()

        def eager_logp(q_np) -> float:
            vi = tvi.replace_flat(torch.as_tensor(q_np, dtype=torch.float32,
                                                  device=dev))
            # eager=True: a reject() in the model ABORTS the run (shortcut)
            return float(m._eval_logp(vi, ctx, eager=True))

        q = tvi.flat().detach().cpu().numpy()
        logp = eager_logp(q)
        qs, logps, accs = [], [], []
        n_early = 0
        for _ in range(num_samples):
            q_new = q + self.proposal_scale * rng.standard_normal(dim)
            logp_new = eager_logp(q_new)
            if np.isneginf(logp_new):
                n_early += 1
            accept = np.log(rng.uniform()) < (logp_new - logp)
            if accept and np.isfinite(logp_new):
                q, logp = q_new, logp_new
            qs.append(q.copy())
            logps.append(logp)
            accs.append(bool(accept))
        qs = torch.as_tensor(np.stack(qs), dtype=torch.float32, device=dev)
        chain = HMC()._package(m, tvi, qs[None], np.asarray(logps)[None],
                               np.asarray(accs, dtype=np.float32)[None])
        chain.stats["n_early_rejected"] = np.asarray(n_early)
        return chain
