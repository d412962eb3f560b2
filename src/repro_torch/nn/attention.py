"""Attention: GQA/MQA (+ sliding window, softcap), DeepSeek-V2's
multi-head latent attention (MLA) and cross attention.

All functions are pure in their parameters: ``params`` is a dict of
tensors and shapes are (batch, seq, ...). Causal masking is position-based
so the same code serves training (full sequence), prefill and one-token
decode with a KV cache. The score/softmax/PV core is either the dense
PyTorch path or the hand-written flash-attention kernel (``impl="flash"``),
selected per call.

KV caches are written IN PLACE (``index_copy_``), as the JAX serving loop
donates its cache: the dict returned as the new cache holds the same
``k`` and ``v`` tensors as the one passed in. The write offset
``cache["pos"]`` stays on the device: no call reads it back to the host.

MLA caches the compressed latent ``c_kv`` and the rotary key ``k_rope``
and decompresses every head's keys and values from the whole cache at each
call, as the JAX package does; its scores and softmax are plain PyTorch in
float32 on either route (the JAX package's ``impl`` is accepted and
unused there too, so no flash kernel runs on an MLA layer).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.nn.common import Initializer, apply_rope, rope, softcap

__all__ = ["init_gqa_params", "gqa_attention", "init_cross_params",
           "cross_attention", "encode_memory_kv", "make_kv_cache",
           "attention_core", "init_mla_params", "make_mla_cache",
           "mla_attention"]


# ---------------------------------------------------------------------------
# core: dense or flash attention over (B,Sq,KV,G,hd) x (B,Sk,KV,hd)
# ---------------------------------------------------------------------------
def attention_core(q, k, v, *, q_positions, kv_positions, causal: bool,
                   window: Optional[int], cap: Optional[float],
                   impl: str = "xla", kv_mask=None):
    """q: (B,Sq,KV,G,hd); k,v: (B,Sk,KV,hd). Returns (B,Sq,KV,G,hd).

    ``impl="xla"`` is the dense path (the JAX package's name for it);
    ``impl="flash"`` the flash-attention kernel."""
    if impl == "flash":
        from repro_torch.kernels.flash_attention import ops as flash_ops
        return flash_ops.flash_attention_gqa(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, window=window, cap=cap, kv_mask=kv_mask)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    scores = softcap(scores, cap) if cap is not None else scores
    mask = None
    dq = q_positions[:, :, None]          # (B,Sq,1)
    dk = kv_positions[:, None, :]         # (B,1,Sk)

    def _and(m, term):
        return term if m is None else (m & term)

    if causal:
        mask = _and(mask, dk <= dq)
    if window is not None:
        mask = _and(mask, dq - dk < window)
    if kv_mask is not None:               # (B,Sk) validity (e.g. cache fill)
        mask = _and(mask, kv_mask[:, None, :])
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", probs, v)


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------
def init_gqa_params(init: Initializer, path: str, d_model: int, n_heads: int,
                    n_kv: int, head_dim: int) -> Dict[str, Any]:
    return {
        "wq": init.dense(f"{path}/wq", (d_model, n_heads, head_dim)),
        "wk": init.dense(f"{path}/wk", (d_model, n_kv, head_dim)),
        "wv": init.dense(f"{path}/wv", (d_model, n_kv, head_dim)),
        "wo": init.dense(f"{path}/wo", (n_heads, head_dim, d_model),
                         fan_in=n_heads * head_dim),
    }


def make_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _proj(x, w):
    """(B,S,D) @ (D,H,hd) -> (B,S,H,hd)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:2], *w.shape[1:])


def _ring_positions(last, T: int, B: int):
    """Absolute position held by each of a ring's T slots when the newest
    token is ``last`` (a device scalar), and whether the slot holds one."""
    slot_ids = torch.arange(T, dtype=torch.int32, device=last.device)
    abs_pos = last - torch.remainder(last - slot_ids, T)
    return (abs_pos[None].expand(B, T), (abs_pos >= 0)[None].expand(B, T))


def gqa_attention(params, x, *, positions, cache: Optional[Dict] = None,
                  causal: bool = True, window: Optional[int] = None,
                  cap: Optional[float] = None, rope_base: float = 10000.0,
                  ring: bool = False,
                  impl: str = "xla") -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,D). With a cache, appends S new positions (S=1 for decode).

    ``ring=True`` (sliding-window layers): the cache is a RING BUFFER of
    ``T <= window`` slots, the token at position t in slot t % T. A
    multi-token call (prefill) attends over the slots' old keys and all S
    new keys, THEN writes the last min(S, T) new keys into the ring. The
    JAX package writes first and attends over the ring alone, so when S >=
    T every query but the last loses the keys of its window that the write
    overwrote (ROADMAP Queue 3).
    """
    B, S, _ = x.shape
    n_heads, head_dim = params["wq"].shape[1], params["wq"].shape[2]
    n_kv = params["wk"].shape[1]
    g = n_heads // n_kv

    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])

    cos, sin = rope(positions, head_dim, rope_base)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        start = cache["pos"][0]  # uniform offsets across the batch, on device
        T = cache["k"].shape[1]
        ck, cv = cache["k"], cache["v"]
        new_idx = start + torch.arange(S, dtype=torch.int64, device=x.device)
        if ring and S > 1:
            old_pos, old_ok = _ring_positions(start - 1, T, B)
            k_full = torch.cat([ck, k], dim=1)
            v_full = torch.cat([cv, v], dim=1)
            kv_positions = torch.cat([old_pos, positions.to(torch.int32)], 1)
            kv_mask = torch.cat([old_ok, torch.ones_like(positions,
                                                         dtype=torch.bool)], 1)
            W = min(S, T)
            slots = torch.remainder(new_idx[S - W:], T)
            ck.index_copy_(1, slots, k[:, S - W:])
            cv.index_copy_(1, slots, v[:, S - W:])
        elif ring:
            slots = torch.remainder(new_idx, T)
            ck.index_copy_(1, slots, k)
            cv.index_copy_(1, slots, v)
            kv_positions, kv_mask = _ring_positions(start + S - 1, T, B)
            k_full, v_full = ck, cv
        else:
            ck.index_copy_(1, new_idx, k)
            cv.index_copy_(1, new_idx, v)
            kv_positions = torch.arange(T, dtype=torch.int32,
                                        device=x.device)[None].expand(B, T)
            kv_mask = kv_positions < (cache["pos"][:, None] + S)
            k_full, v_full = ck, cv
        new_cache = {"k": ck, "v": cv, "pos": cache["pos"] + S}
    else:
        new_cache = None
        kv_positions = positions
        kv_mask = None
        k_full, v_full = k, v

    qg = q.reshape(B, S, n_kv, g, head_dim)
    out = attention_core(qg, k_full, v_full, q_positions=positions,
                         kv_positions=kv_positions, causal=causal,
                         window=window, cap=cap, impl=impl, kv_mask=kv_mask)
    out = out.reshape(B, S, n_heads * head_dim)
    y = out @ params["wo"].reshape(n_heads * head_dim, -1)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention (compressed KV cache)
# ---------------------------------------------------------------------------
def init_mla_params(init: Initializer, path: str, d_model: int, n_heads: int,
                    kv_lora: int, qk_nope: int, qk_rope: int,
                    v_head: int) -> Dict[str, Any]:
    return {
        "wq": init.dense(f"{path}/wq", (d_model, n_heads, qk_nope + qk_rope)),
        "w_dkv": init.dense(f"{path}/w_dkv", (d_model, kv_lora)),
        "w_krope": init.dense(f"{path}/w_krope", (d_model, qk_rope)),
        "w_uk": init.dense(f"{path}/w_uk", (kv_lora, n_heads, qk_nope),
                           fan_in=kv_lora),
        "w_uv": init.dense(f"{path}/w_uv", (kv_lora, n_heads, v_head),
                           fan_in=kv_lora),
        "wo": init.dense(f"{path}/wo", (n_heads, v_head, d_model),
                         fan_in=n_heads * v_head),
    }


def make_mla_cache(batch: int, max_len: int, kv_lora: int, qk_rope: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """MLA caches the COMPRESSED latent and the rotary key: kv_lora +
    qk_rope values a token (576 at deepseek) where GQA keeps heads x
    head_dim x 2."""
    return {
        "c_kv": torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, qk_rope), dtype=dtype,
                              device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_attention(params, x, *, positions, cache: Optional[Dict] = None,
                  rope_base: float = 10000.0,
                  impl: str = "xla") -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,D). With a cache, writes the S new latents and rotary keys
    at ``cache["pos"][0]`` (one offset for every row, clamped so that the
    S rows fit, as ``dynamic_update_slice`` clamps it) and attends over the
    cache. ``impl`` is accepted and unused, as in the JAX package."""
    B, S, _ = x.shape
    n_heads = params["wq"].shape[1]
    qk_rope = params["w_krope"].shape[1]
    qk_nope = params["wq"].shape[2] - qk_rope
    v_head = params["w_uv"].shape[2]

    q = _proj(x, params["wq"])
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    c_kv = x @ params["w_dkv"]
    k_rope_new = x @ params["w_krope"]

    cos, sin = rope(positions, qk_rope, rope_base)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is not None:
        c_full, r_full = cache["c_kv"], cache["k_rope"]
        T = c_full.shape[1]
        start = torch.clamp(cache["pos"][0], 0, T - S)  # on the device
        new_idx = start + torch.arange(S, dtype=torch.int64, device=x.device)
        c_full.index_copy_(1, new_idx, c_kv)
        r_full.index_copy_(1, new_idx, k_rope_new)
        new_cache = {"c_kv": c_full, "k_rope": r_full,
                     "pos": cache["pos"] + S}
        kv_positions = torch.arange(T, dtype=torch.int32,
                                    device=x.device)[None].expand(B, T)
        kv_mask = kv_positions < (cache["pos"][:, None] + S)
    else:
        new_cache = None
        c_full, r_full = c_kv, k_rope_new
        kv_positions = positions
        kv_mask = None

    # decompress every head's K and V from the latent
    k_nope = _proj(c_full, params["w_uk"])
    v = _proj(c_full, params["w_uv"])

    # float32 scores, as preferred_element_type=float32 gives them
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    scores = (torch.einsum("bshk,bthk->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             r_full.float())) * scale
    dq = positions[:, None, :, None]
    dk = kv_positions[:, None, None, :]
    mask = dk <= dq
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthk->bshk", probs, v)
    y = out.reshape(B, S, n_heads * v_head) @ params["wo"].reshape(
        n_heads * v_head, -1)
    return y, new_cache


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------
def init_cross_params(init: Initializer, path: str, d_model: int,
                      n_heads: int, n_kv: int, head_dim: int):
    return init_gqa_params(init, path, d_model, n_heads, n_kv, head_dim)


def cross_attention(params, x, memory_kv, *,
                    impl: str = "xla") -> torch.Tensor:
    """x: (B,S,D) decoder states; memory_kv: dict with precomputed k/v
    (B,T,KV,hd) from the encoder output (computed once per request)."""
    B, S, _ = x.shape
    n_heads, head_dim = params["wq"].shape[1], params["wq"].shape[2]
    n_kv = params["wk"].shape[1]
    g = n_heads // n_kv
    q = _proj(x, params["wq"])
    k, v = memory_kv["k"], memory_kv["v"]
    T = k.shape[1]
    qg = q.reshape(B, S, n_kv, g, head_dim)
    q_positions = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    kv_positions = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    out = attention_core(qg, k, v, q_positions=q_positions,
                         kv_positions=kv_positions, causal=False,
                         window=None, cap=None, impl=impl)
    out = out.reshape(B, S, n_heads * head_dim)
    return out @ params["wo"].reshape(n_heads * head_dim, -1)


def encode_memory_kv(params, memory) -> Dict[str, Any]:
    """Precompute cross-attention K/V from encoder output."""
    return {"k": _proj(memory, params["wk"]), "v": _proj(memory, params["wv"])}
