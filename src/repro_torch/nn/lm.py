"""LM assembly: ArchConfig -> params, train forward, prefill, decode.

One generic machine covers the architectures through a repeating LAYER
PATTERN of typed blocks, as in ``repro.nn.lm``:

  "global" — full-attention block (+MLP)
  "local"  — sliding-window attention (+MLP), a ring-buffer cache
  "mla"    — DeepSeek-V2 multi-head latent attention (+MLP or MoE)
  "ssd"    — Mamba-2 SSD mixer (mixer-only block)

Layers from ``first_dense`` on take a Mixture-of-Experts FFN in MoE
configs (``repro_torch.nn.moe``; ``moe_impl`` picks the dispatch).
"rglru" blocks (RG-LRU) raise ``NotImplementedError`` until ROADMAP Queue
1 item 9b ports them. Parameters are dicts of tensors with the JAX
pytree's structure, stacked per segment (``params["segments"][si][pi]``
holds a leading axis of ``count`` when a segment repeats), so a JAX
pytree carries across key for key (``repro_torch.convert``). PyTorch runs
eagerly, so the trunk is a plain loop over layers (``scan_layers`` is
accepted and changes nothing); ``remat`` checkpoints each super-block in
training, as the JAX package's ``jax.checkpoint`` of its scan body.

Caches are updated IN PLACE, as the JAX serving loop donates its cache:
``prefill`` and ``decode_step`` return the cache they were given, with
every layer's slice written.

Encoder-decoder (seamless) and VLM prefix stubs are handled in
``forward_train`` / ``prefill`` / ``decode_step`` via config flags.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn.common import (Initializer, f32_product, geglu,
                                   relu2_mlp, rms_norm, softcap, swiglu)

__all__ = ["ArchConfig", "init_params", "forward_train", "init_cache",
           "prefill", "decode_step", "lm_loss", "build_segments",
           "encode", "count_params", "make_cross_kv", "tree_map",
           "tree_leaves"]

_LATER = "ROADMAP Queue 1 item 9b"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_type: str = "swiglu"        # swiglu|geglu|relu2
    layer_pattern: Tuple[str, ...] = ("global",)
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norm: bool = False         # gemma2-style post-block norms
    rope_base: float = 10000.0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_shared: Optional[int] = None
    first_dense: int = 0
    dense_ff: Optional[int] = None
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"         # gspmd (moe_ffn) | ep (moe_ffn_ep)
    # MLA
    mla: bool = False
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    # SSM (mamba2)
    d_state: int = 0
    d_inner: int = 0
    ssm_head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1
    # RG-LRU (not ported yet)
    lru_width: Optional[int] = None
    # enc-dec
    enc_layers: int = 0
    # modality prefix stub (vlm: patches; audio: frames via encoder)
    n_prefix: int = 0
    dtype: Any = torch.bfloat16
    # recompute each trunk super-block (and encoder layer) in the backward
    # (torch.utils.checkpoint) instead of keeping its activations
    remat: bool = True
    # "nothing": recompute everything in the backward (least memory);
    # "dots": keep the outputs of unbatched matrix products (aten.mm,
    # aten.addmm) and recompute the rest, as jax's
    # dots_with_no_batch_dims_saveable
    remat_policy: str = "nothing"
    attn_impl: str = "xla"          # xla (dense) | flash (the kernels)
    # accepted for the JAX package's configs: the trunk is a plain loop
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_uses_moe(self, layer_idx: int) -> bool:
        return self.moe and layer_idx >= self.first_dense


def tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts and lists of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[str, ...]   # block types within one super-block
    count: int                 # how many super-blocks
    start_layer: int           # absolute index of first layer (moe switch)


def build_segments(cfg: ArchConfig) -> List[Segment]:
    segs: List[Segment] = []
    p = len(cfg.layer_pattern)
    layer = 0
    n = cfg.n_layers
    # leading dense layers in MoE models (deepseek layer 0)
    if cfg.moe and cfg.first_dense > 0:
        lead = cfg.first_dense
        segs.append(Segment(tuple(cfg.layer_pattern[i % p]
                                  for i in range(lead)), 1, 0))
        layer += lead
    full = (n - layer) // p
    if full > 0:
        segs.append(Segment(tuple(cfg.layer_pattern), full, layer))
        layer += full * p
    rem = n - layer
    if rem > 0:
        segs.append(Segment(tuple(cfg.layer_pattern[i % p]
                                  for i in range(rem)), 1, layer))
    return segs


# ---------------------------------------------------------------------------
# per-block param init
# ---------------------------------------------------------------------------
def _init_mlp(init: Initializer, path: str, cfg: ArchConfig,
              d_ff: int) -> Dict[str, Any]:
    d = cfg.d_model
    if cfg.mlp_type == "relu2":
        return {"w_up": init.dense(f"{path}/up", (d, d_ff)),
                "w_down": init.dense(f"{path}/down", (d_ff, d), fan_in=d_ff)}
    return {"w_gate": init.dense(f"{path}/gate", (d, d_ff)),
            "w_up": init.dense(f"{path}/up", (d, d_ff)),
            "w_down": init.dense(f"{path}/down", (d_ff, d), fan_in=d_ff)}


def _init_block(init: Initializer, path: str, cfg: ArchConfig, btype: str,
                layer_idx: int) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": init.zeros(f"{path}/ln1", (d,))}
    if cfg.post_norm:
        p["post_ln1"] = init.zeros(f"{path}/post_ln1", (d,))
    if btype in ("global", "local"):
        p["attn"] = attn.init_gqa_params(init, f"{path}/attn", d, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.resolved_head_dim)
    elif btype == "ssd":
        p["mix"] = ssm_lib.init_mamba2_params(
            init, f"{path}/ssd", d, cfg.d_inner, cfg.d_state,
            cfg.ssm_head_dim, n_groups=cfg.n_groups)
        return p  # mamba2 block has no separate MLP
    elif btype == "mla":
        p["attn"] = attn.init_mla_params(init, f"{path}/mla", d, cfg.n_heads,
                                         cfg.kv_lora, cfg.qk_nope,
                                         cfg.qk_rope, cfg.v_head)
    elif btype == "rglru":
        raise NotImplementedError(f"'{btype}' blocks are not ported yet "
                                  f"({_LATER})")
    else:
        raise ValueError(f"unknown block type {btype}")

    p["ln2"] = init.zeros(f"{path}/ln2", (d,))
    if cfg.post_norm:
        p["post_ln2"] = init.zeros(f"{path}/post_ln2", (d,))
    if cfg.layer_uses_moe(layer_idx):
        p["moe"] = moe_lib.init_moe_params(
            init, f"{path}/moe", d, cfg.d_ff, cfg.n_experts,
            n_shared=cfg.n_shared, d_shared=cfg.d_shared)
    else:
        d_ff = cfg.dense_ff if (cfg.moe and cfg.dense_ff) else cfg.d_ff
        p["mlp"] = _init_mlp(init, f"{path}/mlp", cfg, d_ff)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from ``seed`` (see ``Initializer``) on ``device``
    (the card unless the caller asks for the CPU; ``"meta"`` for shapes
    and types only)."""
    init = Initializer(seed, cfg.dtype, resolve_device(device))
    params: Dict[str, Any] = {
        "embed_table": init.embed("embed", (cfg.vocab, cfg.d_model)),
        "final_norm": init.zeros("final_norm", (cfg.d_model,)),
    }
    if cfg.n_prefix > 0:
        params["prefix_proj"] = init.dense("prefix_proj",
                                           (cfg.d_model, cfg.d_model))
    seg_params = []
    for si, seg in enumerate(build_segments(cfg)):
        pos_params = []
        for pi, btype in enumerate(seg.pattern):
            if seg.count == 1:
                pos_params.append(_init_block(
                    init, f"seg{si}/p{pi}", cfg, btype,
                    seg.start_layer + pi))
            else:
                # each block written into its slice of the stacked leaves
                # as it is made: the peak is the stack and one block
                stacked = None
                for c in range(seg.count):
                    blk = _init_block(
                        init, f"seg{si}/b{c}/p{pi}", cfg, btype,
                        seg.start_layer + c * len(seg.pattern) + pi)
                    if stacked is None:
                        stacked = tree_map(lambda x: x.new_empty(
                            (seg.count,) + tuple(x.shape)), blk)
                    tree_map(lambda dst, x, c=c: dst[c].copy_(x), stacked,
                             blk)
                pos_params.append(stacked)
        seg_params.append(pos_params)
    params["segments"] = seg_params

    if cfg.enc_layers > 0:
        enc = [_init_block(init, f"enc{li}", cfg, "global", li)
               for li in range(cfg.enc_layers)]
        cross = [attn.init_cross_params(init, f"cross{li}", cfg.d_model,
                                        cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim)
                 for li in range(cfg.n_layers)]
        params["encoder"] = tree_map(lambda *xs: torch.stack(xs), *enc)
        params["enc_final_norm"] = init.zeros("enc_final_norm", (cfg.d_model,))
        params["cross"] = tree_map(lambda *xs: torch.stack(xs), *cross)
        params["cross_ln"] = init.zeros("cross_ln", (cfg.n_layers, cfg.d_model))
    return params


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# block application (shared by train / prefill / decode paths)
# ---------------------------------------------------------------------------
def _mlp_apply(cfg: ArchConfig, p: Dict, x):
    if "moe" in p:
        fn = moe_lib.moe_ffn_ep if cfg.moe_impl == "ep" else moe_lib.moe_ffn
        return fn(p["moe"], x, top_k=cfg.top_k,
                  capacity_factor=cfg.capacity_factor)
    m = p["mlp"]
    if cfg.mlp_type == "relu2":
        return relu2_mlp(x, m["w_up"], m["w_down"])
    if cfg.mlp_type == "geglu":
        return geglu(x, m["w_gate"], m["w_up"], m["w_down"])
    return swiglu(x, m["w_gate"], m["w_up"], m["w_down"])


def _apply_block(cfg: ArchConfig, btype: str, p: Dict, x, *, positions,
                 cache=None, memory_kv=None, cross_p=None, cross_ln=None,
                 decode: bool = False):
    """Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"])
    new_cache = None
    if btype in ("global", "local"):
        window = cfg.window if btype == "local" else None
        # bounded-window layers use the RING-BUFFER cache (O(window) slots)
        ring = (btype == "local" and window is not None
                and cache is not None and cache["k"].shape[1] <= window)
        out, new_cache = attn.gqa_attention(
            p["attn"], h, positions=positions, cache=cache, causal=True,
            window=window, cap=cfg.attn_softcap, rope_base=cfg.rope_base,
            ring=ring, impl=cfg.attn_impl)
    elif btype == "mla":
        out, new_cache = attn.mla_attention(
            p["attn"], h, positions=positions, cache=cache,
            rope_base=cfg.rope_base, impl=cfg.attn_impl)
    elif btype == "ssd":
        kw = dict(d_inner=cfg.d_inner, d_state=cfg.d_state,
                  head_dim=cfg.ssm_head_dim, n_groups=cfg.n_groups)
        if decode:
            out, new_cache = ssm_lib.mamba2_decode_step(p["mix"], h, cache,
                                                        **kw)
        elif cache is not None:
            # prefill: mixer + write final SSM state / conv tail to cache
            out, new_cache = ssm_lib.mamba2_prefill(p["mix"], h, cache,
                                                    chunk=cfg.chunk, **kw)
        else:
            out = ssm_lib.mamba2_mixer(
                p["mix"], h, chunk=cfg.chunk,
                impl="pallas" if cfg.attn_impl == "flash" else "xla", **kw)
        if cfg.post_norm:
            out = rms_norm(out, p["post_ln1"])
        return x + out, new_cache
    else:
        raise NotImplementedError(f"'{btype}' blocks are not ported yet "
                                  f"({_LATER})")
    if cfg.post_norm:
        out = rms_norm(out, p["post_ln1"])
    x = x + out

    # cross attention (enc-dec decoder layers); memory_kv holds this
    # layer's precomputed {"k","v"} (computed once per request)
    if cross_p is not None:
        hc = rms_norm(x, cross_ln)
        x = x + attn.cross_attention(cross_p, hc, memory_kv,
                                     impl=cfg.attn_impl)

    h2 = rms_norm(x, p["ln2"])
    out2 = _mlp_apply(cfg, p, h2)
    if cfg.post_norm:
        out2 = rms_norm(out2, p["post_ln2"])
    return x + out2, new_cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _block_cache(cfg: ArchConfig, btype: str, batch: int, max_len: int,
                 device):
    if btype == "global":
        return attn.make_kv_cache(batch, max_len, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, cfg.dtype, device)
    if btype == "local":
        T = max_len if cfg.window is None else min(max_len, max(cfg.window, 1))
        return attn.make_kv_cache(batch, T, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, cfg.dtype, device)
    if btype == "ssd":
        return ssm_lib.make_mamba2_cache(batch, cfg.d_inner, cfg.d_state,
                                         cfg.ssm_head_dim, cfg.n_groups,
                                         dtype=cfg.dtype, device=device)
    if btype == "mla":
        return attn.make_mla_cache(batch, max_len, cfg.kv_lora, cfg.qk_rope,
                                   cfg.dtype, device)
    if btype == "rglru":
        raise NotImplementedError(f"'{btype}' caches are not ported yet "
                                  f"({_LATER})")
    raise ValueError(btype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Per-segment, per-pattern-position caches (stacked over count), on
    the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    seg_caches = []
    for seg in build_segments(cfg):
        pos_caches = []
        for btype in seg.pattern:
            c = _block_cache(cfg, btype, batch, max_len, device)
            if seg.count > 1:
                c = tree_map(lambda x: x[None].repeat(
                    (seg.count,) + (1,) * x.dim()), c)
            pos_caches.append(c)
        seg_caches.append(pos_caches)
    return seg_caches


def _write_back(cache: Dict, new: Dict) -> None:
    """Store a block's new cache into its slice of the stacked cache."""
    for key, val in new.items():
        if val is not cache[key]:
            cache[key].copy_(val)


# ---------------------------------------------------------------------------
# remat: torch.utils.checkpoint around each super-block
# ---------------------------------------------------------------------------
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep unbatched matrix products, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, policy: str):
    """``run(fn, x)``: ``fn(x)`` under ``torch.utils.checkpoint`` with the
    policy ``"nothing"`` or ``"dots"``, or None where remat does not apply:
    ``cfg.remat`` off, gradients off (nothing to save), or inside a
    ``torch.func`` transform, which switches saved-tensor hooks off: there
    (``make_sgld_step``'s ``torch.func.grad``, say) every activation is
    kept, where ``jax.checkpoint`` still applies under ``jax.grad``. The
    values are the same; only the memory differs."""
    from repro_torch.core.program import in_transform
    if not (cfg.remat and torch.is_grad_enabled()) or in_transform():
        return None
    from torch.utils import checkpoint as ckpt
    if policy == "dots":
        def context_fn():
            return ckpt.create_selective_checkpoint_contexts(_dots_policy)
    elif policy == "nothing":
        context_fn = ckpt.noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy '{policy}'; expected "
                         "'nothing' or 'dots'")

    def run(fn, x):
        # no dropout in the blocks: no RNG state to stash (a stash reads
        # the generator's state, which a CUDA graph capture refuses)
        return ckpt.checkpoint(fn, x, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=context_fn)

    return run


# ---------------------------------------------------------------------------
# trunk runner (shared): a plain loop over segments and layers
# ---------------------------------------------------------------------------
def _run_trunk(cfg: ArchConfig, params, x, positions, caches=None,
               decode: bool = False, memory_kv=None):
    """Every block in order. Without caches (training), each super-block
    (one pass of the segment's pattern) runs under remat when it applies
    (``_remat``), as the JAX package checkpoints its scan body."""
    remat = _remat(cfg, cfg.remat_policy) if caches is None else None
    layer_idx = 0  # absolute layer counter for cross-attn param slicing
    for si, seg in enumerate(build_segments(cfg)):
        seg_p = params["segments"][si]
        seg_c = caches[si] if caches is not None else None
        for c in range(seg.count):
            def body(x, c=c, seg=seg, seg_p=seg_p, seg_c=seg_c,
                     first=layer_idx):
                for pi, btype in enumerate(seg.pattern):
                    if seg.count == 1:
                        blk_p = seg_p[pi]
                        blk_c = seg_c[pi] if seg_c is not None else None
                    else:
                        blk_p = tree_map(lambda a: a[c], seg_p[pi])
                        blk_c = (tree_map(lambda a: a[c], seg_c[pi])
                                 if seg_c is not None else None)
                    cross_p = cross_ln = layer_kv = None
                    if memory_kv is not None:
                        li = first + pi
                        cross_p = tree_map(lambda a: a[li], params["cross"])
                        cross_ln = params["cross_ln"][li]
                        layer_kv = {"k": memory_kv["k"][li],
                                    "v": memory_kv["v"][li]}
                    x, nc = _apply_block(cfg, btype, blk_p, x,
                                         positions=positions, cache=blk_c,
                                         memory_kv=layer_kv, cross_p=cross_p,
                                         cross_ln=cross_ln, decode=decode)
                    if blk_c is not None:
                        _write_back(blk_c, nc)
                return x

            x = body(x) if remat is None else remat(body, x)
            layer_idx += len(seg.pattern)
    return x, caches


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _embed(cfg: ArchConfig, params, tokens):
    x = params["embed_table"][tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg: ArchConfig, params, x):
    x = rms_norm(x, params["final_norm"])
    logits = f32_product(x, params["embed_table"])
    return softcap(logits, cfg.final_softcap)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode(cfg: ArchConfig, params, frames):
    """Encoder stack over prefix frame embeddings (audio enc-dec)."""
    x = frames @ params["prefix_proj"] if "prefix_proj" in params else frames
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    # the JAX package checkpoints the encoder's body with jax.checkpoint's
    # default policy: nothing saved
    remat = _remat(cfg, "nothing")
    for li in range(cfg.enc_layers):
        def body(x, li=li):
            p = tree_map(lambda a: a[li], params["encoder"])
            h = rms_norm(x, p["ln1"])
            out, _ = attn.gqa_attention(p["attn"], h, positions=positions,
                                        causal=False, rope_base=cfg.rope_base,
                                        impl=cfg.attn_impl)
            x = x + out
            h2 = rms_norm(x, p["ln2"])
            m = p["mlp"]
            return x + swiglu(h2, m["w_gate"], m["w_up"], m["w_down"])

        x = body(x) if remat is None else remat(body, x)
    return rms_norm(x, params["enc_final_norm"])


def make_cross_kv(cfg: ArchConfig, params, memory):
    """Every decoder layer's cross-attention K/V from encoder memory
    (computed once per request, reused by all decode steps)."""
    ck = torch.einsum("btd,ldhk->lbthk", memory, params["cross"]["wk"])
    cv = torch.einsum("btd,ldhk->lbthk", memory, params["cross"]["wv"])
    return {"k": ck, "v": cv}


def _prepare(cfg: ArchConfig, params, tokens, prefix_embeds, enc_frames):
    """Embedded tokens (with any prefix prepended) and the cross K/V."""
    x = _embed(cfg, params, tokens)
    memory_kv = None
    if cfg.enc_layers > 0 and enc_frames is not None:
        memory_kv = make_cross_kv(cfg, params, encode(cfg, params, enc_frames))
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype) @ params["prefix_proj"]
        x = torch.cat([pe, x], dim=1)
    return x, memory_kv


def forward_train(cfg: ArchConfig, params, tokens, prefix_embeds=None,
                  enc_frames=None):
    """tokens: (B,S) -> logits (B,S,V), float32. Prefix embeds are
    prepended (VLM); enc_frames trigger the encoder-decoder path (audio)."""
    x, memory_kv = _prepare(cfg, params, tokens, prefix_embeds, enc_frames)
    B, S = x.shape[:2]
    x, _ = _run_trunk(cfg, params, x, _positions(B, S, x.device),
                      caches=None, decode=False, memory_kv=memory_kv)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    return _logits(cfg, params, x)


def lm_loss(cfg: ArchConfig, params, tokens, labels, prefix_embeds=None,
            enc_frames=None):
    logits = forward_train(cfg, params, tokens, prefix_embeds, enc_frames)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def prefill(cfg: ArchConfig, params, tokens, cache, prefix_embeds=None,
            enc_frames=None):
    """Run the prompt through the trunk, writing ``cache`` in place.
    Returns (last position's logits (B,1,V), cache)."""
    x, memory_kv = _prepare(cfg, params, tokens, prefix_embeds, enc_frames)
    B, S = x.shape[:2]
    x, cache = _run_trunk(cfg, params, x, _positions(B, S, x.device),
                          caches=cache, decode=False, memory_kv=memory_kv)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params, token, cache, pos, memory_kv=None):
    """token: (B,1); pos: (B,) absolute positions. One-token decode,
    writing ``cache`` in place."""
    x = _embed(cfg, params, token)
    positions = pos[:, None].to(torch.int32)
    x, cache = _run_trunk(cfg, params, x, positions, caches=cache,
                          decode=True, memory_kv=memory_kv)
    return _logits(cfg, params, x), cache
