"""The LM architectures as DynamicPPL models, as ``repro.models.bayes_lm``.

The transformer (or SSM) backbone runs INSIDE an ``@model``: the
parameters carry a Gaussian prior (``prior_factor``: a prior-weighted
term for dict-valued weights) and the tokens are one vectorised
Categorical ``observe`` site, which the fused evaluator sends to the
``categorical_logits_sum`` kernel. ``logp_with_context`` under a
``MiniBatchContext(scale=N_total/B)`` gives the paper's §3.1 scaled
log-joint.

``make_train_step`` returns the training step as ``repro``'s:
  * mode="map"  — MAP-AdamW on the scaled log-joint (the production
                  pretraining path; weight decay IS the Gaussian prior).
  * mode="sgld" — preconditioned SGLD: posterior SAMPLING at scale.
Its gradient is ``torch.autograd.grad`` over the parameter leaves (remat's
``torch.utils.checkpoint`` and the kernels' autograd Functions run under
it), and the step is one cached ``CompiledProgram``: a CUDA graph from its
second call on the card, with the state written in place (``repro``
donates it).

``make_serve_step`` is the posterior-predictive decode with a KV cache,
``make_prefill_step`` its prefill.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils._pytree import (register_pytree_node, tree_flatten,
                                 tree_map, tree_unflatten)

from repro_torch import optim
from repro_torch.core.contexts import MiniBatchContext
from repro_torch.core.model import model
from repro_torch.core.primitives import observe, prior_factor
from repro_torch.core.program import (CompiledProgram, ProgramKey,
                                      program_cache, write_into)
from repro_torch.dists import Categorical
from repro_torch.infer.sgld import SGLD
from repro_torch.nn import lm
from repro_torch.sharding import constrain

__all__ = ["make_lm_model", "make_train_step", "make_serve_step",
           "make_prefill_step", "tree_normal_logprior", "TrainState"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


# elements of a leaf upcast to float32 at a time in the prior (1 GiB):
# deepseek-v2-lite-16b's stacked experts hold 4.8 G elements a leaf
_PRIOR_CHUNK = 1 << 28


def tree_normal_logprior(params, sigma: float = 1.0) -> torch.Tensor:
    """sum over leaves of Normal(0, sigma).log_prob — the weight prior.
    Each leaf is upcast and squared ``_PRIOR_CHUNK`` elements at a time
    (one piece for every leaf below that size)."""
    leaves = lm.tree_leaves(params)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        # -0.5 * sum(...) is sum(-0.5 * ...) exactly: a power-of-two scale
        sq = sum(torch.sum(torch.square(part.float() / sigma))
                 for part in leaf.reshape(-1).split(_PRIOR_CHUNK))
        total = total + (-0.5 * sq
                         - leaf.numel() * (math.log(sigma) + _HALF_LOG_2PI))
    return total


def make_lm_model(cfg: lm.ArchConfig, prior_sigma: float = 1.0):
    """ModelGen: lm_bayes(tokens, labels, params, prefix_embeds, enc_frames).

    The backbone is deterministic inside the model; ``params`` enter as
    bound data with their prior via ``prior_factor``, and the tokens are
    one vectorised Categorical observe site.
    """

    @model
    def lm_bayes(tokens, labels, params, prefix_embeds=None, enc_frames=None):
        prior_factor("params", tree_normal_logprior(params, prior_sigma))
        logits = lm.forward_train(cfg, params, tokens,
                                  prefix_embeds=prefix_embeds,
                                  enc_frames=enc_frames)
        V = logits.shape[-1]
        observe("tokens", Categorical(logits=logits.reshape(-1, V).float()),
                labels.reshape(-1))
        return logits

    return lm_bayes


@dataclasses.dataclass
class TrainState:
    """The training state: ``params`` and ``opt_state`` trees and the step
    count (an int32 tensor). A pytree node without keys, as ``repro``'s,
    so a checkpoint names its leaves ``[<flat index i>]...`` as
    ``repro``'s does."""

    params: Any
    opt_state: Any
    step: torch.Tensor


register_pytree_node(
    TrainState, lambda s: ([s.params, s.opt_state, s.step], None),
    lambda children, ctx: TrainState(*children),
    serialized_type_name="repro_torch.models.bayes_lm.TrainState")


def make_train_step(cfg: lm.ArchConfig, *, total_tokens: float,
                    mode: str = "map", learning_rate: float = 3e-4,
                    prior_sigma: float = 1.0, grad_clip: float = 1.0,
                    microbatch: int = 1,
                    sgld: Optional[SGLD] = None
                    ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) for Bayesian-LM training.

    ``step_fn(state, generator, batch) -> (state, metrics)``: ``metrics``
    holds ``logjoint``, ``nll`` (per token, unscaled likelihood) and
    ``grad_norm`` as device tensors. The step writes the new state into
    ``state``'s tensors and returns ``state`` (``repro`` donates it), so
    the params given to ``init_fn`` are the state's own. ``generator``
    (a ``torch.Generator`` on the params' device) draws SGLD's noise.
    ``microbatch`` > 1 splits the batch's rows into sequential micro-steps
    with float32 gradient accumulation (same numerics, less memory).

    The step is one program of the program cache, keyed on the config,
    the mode, the hyperparameters, ``microbatch`` and the batch's shapes:
    on the card its second call captures it as a CUDA graph (autograd and
    the optimiser inside) and later calls replay it; on the CPU it runs
    eagerly.
    """
    if mode not in ("map", "sgld"):
        raise ValueError(f"unknown mode '{mode}'; expected 'map' or 'sgld'")
    m_gen = make_lm_model(cfg, prior_sigma)
    opt = optim.adamw(learning_rate) if mode == "map" else None
    sgld = sgld if sgld is not None else SGLD(step_size=1e-6)

    def init_fn(params) -> TrainState:
        opt_state = opt.init(params) if opt is not None else sgld.init(params)
        device = lm.tree_leaves(params)[0].device
        return TrainState(params, opt_state,
                          torch.zeros((), dtype=torch.int32, device=device))

    def grad_fn(params, batch):
        """(scaled log-joint, per-token nll, gradient tree)."""
        tokens = batch["tokens"]
        n_batch_tokens = tokens.shape[0] * tokens.shape[1]
        ctx = MiniBatchContext(scale=total_tokens / n_batch_tokens)
        leaves, spec = tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            mdl = m_gen(tokens=tokens, labels=batch["labels"],
                        params=tree_unflatten(live, spec),
                        prefix_embeds=batch.get("prefix_embeds"),
                        enc_frames=batch.get("enc_frames"))
            lp = mdl.logp_with_context({}, ctx)
            grads = torch.autograd.grad(lp, live)
        lp = lp.detach()
        with torch.no_grad():
            # per-token NLL for logging (unscaled likelihood)
            nll = -(lp - tree_normal_logprior(params, prior_sigma)) \
                / ctx.scale / n_batch_tokens
        return lp, nll, tree_unflatten(list(grads), spec)

    def accum_grads(params, batch):
        if microbatch <= 1:
            return grad_fn(params, batch)
        rows = batch["tokens"].shape[0]
        if rows % microbatch:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{microbatch} microbatches")
        per = rows // microbatch
        lp = nll = grads = None
        for i in range(microbatch):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            lp_i, nll_i, g = grad_fn(params, mb)
            g = tree_map(lambda x: x.to(torch.float32), g)
            if grads is None:
                lp, nll, grads = lp_i, nll_i, g
            else:
                lp, nll = lp + lp_i, nll + nll_i
                grads = tree_map(torch.add, grads, g)
        scale = 1.0 / microbatch
        return lp * scale, nll * scale, tree_map(lambda g: g * scale, grads)

    def raw_step(state: TrainState, generator, batch):
        batch = {k: constrain(v, "batch", *([None] * (v.dim() - 1)))
                 for k, v in batch.items()}
        lp, nll, grads = accum_grads(state.params, batch)
        if mode == "map":
            # Adam DESCENDS a loss; pass -grad(logjoint)
            neg = tree_map(torch.neg, grads)
            neg, gnorm = optim.clip_by_global_norm(neg, grad_clip)
            deltas, opt_state = opt.update(neg, state.opt_state,
                                           state.params)
            params = optim.apply_updates(state.params, deltas)
        else:
            grads, gnorm = optim.clip_by_global_norm(grads, grad_clip * 1e9)
            params, opt_state = sgld.step(generator, state.params, grads,
                                          state.opt_state)
        write_into((state.params, state.opt_state, state.step),
                (params, opt_state, state.step + 1))
        return {"logjoint": lp, "nll": nll, "grad_norm": gnorm}

    hyper = (mode, float(total_tokens), float(learning_rate),
             float(prior_sigma), float(grad_clip), int(microbatch),
             sgld if mode == "sgld" else None)
    cache = program_cache()

    def step_fn(state: TrainState, generator: torch.Generator, batch):
        batch = {k: v for k, v in batch.items() if v is not None}
        shapes = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                              for k, v in batch.items()))
        key = ProgramKey(("lm", cfg), "train_step", None, shapes, "fused",
                         hyper)
        prog = cache.get_or_build(
            key, lambda: CompiledProgram(key, raw_step, donate_argnums=(0,)))
        # the new state is written into ``state``'s tensors; the graph's
        # metric tensors are overwritten by its next replay
        metrics = prog(state, generator, batch)
        return state, {k: v.clone() for k, v in metrics.items()}

    return init_fn, step_fn


def make_serve_step(cfg: lm.ArchConfig, temperature: float = 0.0) -> Callable:
    """decode_fn(params, token, cache, pos, generator, memory_kv) ->
    (next_token, logits, cache): one posterior-predictive token."""

    def decode_fn(params, token, cache, pos,
                  generator: Optional[torch.Generator] = None,
                  memory_kv=None):
        logits, cache = lm.decode_step(cfg, params, token, cache, pos,
                                       memory_kv=memory_kv)
        lg = logits[:, -1, :].float()
        if temperature and temperature > 0.0:
            probs = torch.softmax(lg / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        return nxt.to(torch.int32)[:, None], logits, cache

    return decode_fn


def make_prefill_step(cfg: lm.ArchConfig) -> Callable:
    def prefill_fn(params, tokens, cache, prefix_embeds=None,
                   enc_frames=None):
        return lm.prefill(cfg, params, tokens, cache,
                          prefix_embeds=prefix_embeds, enc_frames=enc_frames)

    return prefill_fn
