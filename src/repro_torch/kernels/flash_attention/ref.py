"""Plain PyTorch version of the flash-attention kernel.

The same math as ``repro_torch.nn.attention.attention_core``'s dense path,
kept free of the model code so the kernel is compared with an independent
version: scores, softcap and softmax in float32, fully masked rows give
zeros.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref", "NEG_INF"]

NEG_INF = -1e30  # finite: keeps exp() and max() NaN-free on masked rows


def attention_ref(q, k, v, *, q_positions, kv_positions, causal: bool,
                  window: Optional[int], cap: Optional[float], kv_mask=None):
    """q: (B,Sq,KV,G,hd); k, v: (B,Sk,KV,hd) -> (B,Sq,KV,G,hd) in q's type.

    ``q_positions`` (B,Sq) and ``kv_positions`` (B,Sk) are absolute token
    positions in any order; ``kv_mask`` (B,Sk) marks the valid keys."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    dq = q_positions[:, :, None]
    dk = kv_positions[:, None, :]
    mask = torch.ones(dq.shape[0], dq.shape[1], dk.shape[2], dtype=torch.bool,
                      device=scores.device)
    if causal:
        mask = mask & (dk <= dq)
    if window is not None:
        mask = mask & (dq - dk < window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :].bool()
    mask = mask[:, None, None]                      # (B,1,1,Sq,Sk)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # a fully masked row: softmax is uniform over it; zero it instead
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v.float())
    return out.to(q.dtype)
