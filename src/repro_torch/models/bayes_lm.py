"""The LM architectures as DynamicPPL models, as ``repro.models.bayes_lm``.

The transformer (or SSM) backbone runs INSIDE an ``@model``: the
parameters carry a Gaussian prior (``prior_factor``: a prior-weighted
term for dict-valued weights) and the tokens are one vectorised
Categorical ``observe`` site, which the fused evaluator sends to the
``categorical_logits_sum`` kernel. ``logp_with_context`` under a
``MiniBatchContext(scale=N_total/B)`` gives the paper's §3.1 scaled
log-joint.

``make_serve_step`` is the posterior-predictive decode with a KV cache,
``make_prefill_step`` its prefill. The training step (``make_train_step``,
with ``optim``) waits for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core.model import model
from repro_torch.core.primitives import observe, prior_factor
from repro_torch.dists import Categorical
from repro_torch.nn import lm

__all__ = ["make_lm_model", "make_serve_step", "make_prefill_step",
           "tree_normal_logprior"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def tree_normal_logprior(params, sigma: float = 1.0) -> torch.Tensor:
    """sum over leaves of Normal(0, sigma).log_prob — the weight prior."""
    leaves = lm.tree_leaves(params)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        x = leaf.float()
        total = total + (torch.sum(-0.5 * torch.square(x / sigma))
                         - x.numel() * (math.log(sigma) + _HALF_LOG_2PI))
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

    lm_bayes.lm_config = cfg  # marks an LM model (infer/sgld.py refuses it)
    return lm_bayes


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
