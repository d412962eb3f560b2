"""Data-parallel fused log-density: shard tall data, all-reduce the
likelihood.

For a linked trace the fused log-joint decomposes exactly as

    density(q) = prior(q) + likelihood(q)
               = PriorContext logp  (param sites + log|det J|)
               + LikelihoodContext logp  (observe sites)

and the likelihood is a sum over observations — so partitioning every
tall observed array along its leading axis over the mesh ``data`` axis
and all-reducing the per-shard likelihood
(:func:`repro_torch.kernels.fused_logpdf.ops.all_reduce_block_sum`)
reproduces the unsharded density up to float summation order. Each rank
runs the SAME fused evaluator over its shard (its kernels at the shard's
rows), and the only collective is at the end.

The gradient cannot be taken through the collective: under
``torch.func.vmap`` an all-reduce has no batching rule, and under
``torch.func.grad`` it would silently leave out the other ranks' share
(``repro`` mends the same trap with a ``custom_vjp``). So the density
carries its own batched ``value_and_grad``: the prior's and this shard's
likelihood's value and gradient under ``vmap(grad_and_value)``, then ONE
all-reduce of the packed ``(num_chains, 1 + dim)`` likelihood values and
gradients outside every transform, and the prior added after it. The
samplers take it through that hook (``infer.hmc.value_and_grad``).

Correctness contract (validated where cheap, documented where not):

* every ``shard_sites`` array must have the observation axis leading and
  divisible by the shard count (:func:`shard_slices` checks);
* every likelihood-context site of the model must depend on the sharded
  data (a likelihood term that ignores the data — e.g. a bare
  ``factor`` — would be summed once PER SHARD by the all-reduce).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.contexts import (DefaultContext, LikelihoodContext,
                                       PriorContext)

__all__ = ["ShardedLogDensity", "make_sharded_logdensity", "shard_slices",
           "sharded_arrays"]


def shard_slices(model, shard_sites: Tuple[str, ...],
                 num_shards: int) -> Dict[str, Tuple[int, int]]:
    """Validate shardability; return {site: (total_rows, rows_per_shard)}.

    Raises with the offending site named when a site is not bound, not
    an array, or has a leading dim not divisible by ``num_shards``.
    """
    out = {}
    for site in shard_sites:
        if site not in model.data:
            raise ValueError(
                f"shard site '{site}' is not bound data of model "
                f"'{model.name}' (bound: {sorted(model.data)})")
        v = model.data[site]
        shape = tuple(v.shape) if torch.is_tensor(v) else np.shape(v)
        if len(shape) < 1:
            raise ValueError(
                f"shard site '{site}' is a scalar; data sharding "
                "partitions the leading (observation) axis")
        if shape[0] % num_shards != 0:
            raise ValueError(
                f"shard site '{site}' has leading dim {shape[0]}, not "
                f"divisible by {num_shards} data shards; pad or rebatch")
        out[site] = (int(shape[0]), int(shape[0]) // num_shards)
    return out


def sharded_arrays(model, plan, device=None) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of the plan's shard-site arrays, on its device.

    Each rank keeps only its ``rows / num_shards`` of every site (a copy:
    the full arrays may then go), which is what bounds its memory.
    """
    slices = shard_slices(model, plan.shard_sites, plan.num_data_shards)
    dev = plan.device(device)
    d = plan.coords()[1]
    out = []
    for site in plan.shard_sites:
        _, rows = slices[site]
        v = torch.as_tensor(model.data[site])
        out.append(v[d * rows:(d + 1) * rows].to(dev, copy=True))
    return tuple(out)


class ShardedLogDensity:
    """Flat unconstrained log-density ``R^num_flat -> R`` over a data
    mesh, for ``q (dim,)`` or a chain batch ``q (num_chains, dim)``.

    Calling it evaluates the prior and this rank's likelihood and joins
    the likelihoods with one all-reduce; :attr:`value_and_grad` does the
    same for the value and the gradient together, one all-reduce for
    both. Both run eagerly (a gloo collective goes through the host and a
    CUDA graph cannot hold it), through a ``CompiledProgram`` a kind
    (``"density"``, ``"density_vg"``) for the cache's counters.
    ``evaluations`` counts the ``value_and_grad`` calls.
    """

    def __init__(self, model, tvi_linked, plan, *, backend: str, key,
                 device=None):
        from repro_torch.core.program import CompiledProgram
        from repro_torch.infer.hmc import value_and_grad

        self.plan = plan
        self.key = key
        self.local = sharded_arrays(model, plan, device)
        local = model.bind(**dict(zip(plan.shard_sites, self.local)))

        def prior(flat_u):
            return local.logp_with_context(tvi_linked.replace_flat(flat_u),
                                           PriorContext(), backend=backend)

        def likelihood(flat_u):
            return local.logp_with_context(tvi_linked.replace_flat(flat_u),
                                           LikelihoodContext(),
                                           backend=backend)

        self.prior, self.likelihood = prior, likelihood
        self._prior_vg = value_and_grad(prior)
        self._lik_vg = value_and_grad(likelihood)
        self._prior_b = torch.func.vmap(prior)
        self._lik_b = torch.func.vmap(likelihood)
        self.evaluations = 0
        self.program = CompiledProgram(key, self._value, jit=False)
        self.vg_program = CompiledProgram(key._replace(kind="density_vg"),
                                          self._value_and_grad, jit=False)

    def _value(self, flat_u):
        from repro_torch.kernels.fused_logpdf.ops import all_reduce_block_sum
        if flat_u.dim() == 1:
            prior, lik = self.prior(flat_u), self.likelihood(flat_u)
        else:
            prior, lik = self._prior_b(flat_u), self._lik_b(flat_u)
        return prior + all_reduce_block_sum(lik, self.plan.data_axis)

    def _value_and_grad(self, flat_u):
        from repro_torch.kernels.fused_logpdf.ops import all_reduce_block_sum
        self.evaluations += 1
        prior, prior_grad = self._prior_vg(flat_u)
        lik, lik_grad = self._lik_vg(flat_u)
        both = all_reduce_block_sum(
            torch.cat([lik.unsqueeze(-1), lik_grad], dim=-1),
            self.plan.data_axis)
        return prior + both[..., 0], prior_grad + both[..., 1:]

    def __call__(self, flat_u):
        return self.program(flat_u)

    def value_and_grad(self, flat_u):
        """``(logp, grad)`` of ``q (dim,)`` or ``q (num_chains, dim)``."""
        return self.vg_program(flat_u)


def make_sharded_logdensity(model, tvi_linked, plan, *,
                            backend: str = "fused", cache=None,
                            device=None) -> Callable:
    """Flat unconstrained log-density over the mesh (see the module doc).

    The prior is evaluated replicated, the likelihood against this rank's
    rows of the plan's ``shard_sites`` (bound through ``model.bind``, on
    ``device``: the rank's, CUDA unless the caller asks for the CPU), and
    the two are joined through the all-reduce seam. Every rank of the
    mesh calls it, and each call of the result, together. With one data
    shard this is the plain density.

    The :class:`ShardedLogDensity` is cached in the program cache under a
    key whose ``sharding`` component is the plan's fingerprint (and whose
    tail holds this rank's mesh coordinates and device, which its bound
    rows depend on), so sharded and unsharded densities of one model never
    collide.
    """
    from repro_torch.core.program import (ProgramKey, model_fingerprint,
                                          program_cache)

    if plan.num_data_shards == 1:
        return model.make_logdensity_fn(tvi_linked, backend=backend)
    shard_slices(model, plan.shard_sites, plan.num_data_shards)
    dev = plan.device(device)
    key = ProgramKey(model_fingerprint(model), "density", tvi_linked.layout,
                     (), backend,
                     (DefaultContext(), ("rank", plan.coords(), str(dev))),
                     plan.fingerprint())
    cache = cache if cache is not None else program_cache()
    return cache.get_or_build(key, lambda: ShardedLogDensity(
        model, tvi_linked, plan, backend=backend, key=key, device=dev))
