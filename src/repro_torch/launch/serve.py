"""Batched-request LM serving, as ``repro.launch.serve``'s LM path.

``serve_batch`` groups requests into a fixed batch: one prefill over the
prompts, then greedy (or sampled) decode steps until every request has
``max_new`` tokens. The decode step is one program, as ``repro`` jits it
with its cache donated: it writes the KV cache (the port's donation), the
next token, its position and the token's slot of the output in place, and
advances the position and the slot on the device, so on CUDA every step
after the second is one graph replay, and no step reads a value back to
the host; the generated tokens come back once, at the end. The sampled
route draws from the request's ``torch.Generator``, which the graph
registers. The prefill runs once a batch and stays eager: a capture would
cost more than the one call it would replay.

The probability-query server (``--queries``) waits for ROADMAP Queue 1
item 6.

Usage:
  python -m repro_torch.launch.serve --arch smollm-360m --smoke \\
      --batch 4 --prompt-len 32 --max-new 16 [--device cpu]

The route (dense attention or the kernels) is the config's ``attn_impl``,
as in the JAX package; ``serve_batch(cfg=dataclasses.replace(cfg,
attn_impl="flash"))`` selects the kernels.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.core.program import CompiledProgram, ProgramKey
from repro_torch.models import bayes_lm
from repro_torch.nn import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_program(cfg: lm.ArchConfig,
                   temperature: float = 0.0) -> CompiledProgram:
    """The serving loop's decode step as one program, over its buffers:
    ``step(params, token, cache, pos, out_tokens, idx, generator,
    memory_kv)`` decodes one token after ``token (B, 1)`` at positions
    ``pos (B,)`` (``bayes_lm.make_serve_step``), writes it into ``token``
    and into column ``idx (1,)`` of ``out_tokens (B, max_new)``, writes the
    cache, and advances ``pos`` and ``idx``, all in place (donated)."""
    decode = bayes_lm.make_serve_step(cfg, temperature)

    def decode_body(params, token, cache, pos, out_tokens, idx, generator,
                    memory_kv):
        nxt, _, _ = decode(params, token, cache, pos, generator=generator,
                           memory_kv=memory_kv)
        token.copy_(nxt)
        out_tokens.index_copy_(1, idx, nxt)
        pos.add_(1)
        idx.add_(1)

    return CompiledProgram(
        ProgramKey(("serve", cfg.name), "decode_step", None, (),
                   cfg.attn_impl, (float(temperature),)),
        decode_body, donate_argnums=(1, 2, 3, 4, 5))


def serve_batch(arch: str, *, smoke: bool = True, batch: int = 4,
                prompt_len: int = 32, max_new: int = 16,
                temperature: float = 0.0, seed: int = 0, device=None,
                cfg: Optional[lm.ArchConfig] = None, params=None,
                prompts: Optional[torch.Tensor] = None):
    """Serve ``batch`` requests of ``prompt_len`` random prompt tokens and
    ``max_new`` new tokens each; returns (generated (batch, max_new) int32
    on the host, stats).

    ``cfg`` overrides the registry's config for ``arch`` (e.g. with
    ``attn_impl="flash"`` or a cut depth), ``params`` the random weights
    from ``seed`` and ``prompts`` the random prompt tokens."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = (configs.get_smoke_config(arch) if smoke
               else configs.get_config(arch))
    if params is None:
        params = lm.init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                generator=gen, device=dev)
    batch, prompt_len = prompts.shape

    extras = {}
    memory_kv = None
    n_prefix = 0
    if cfg.enc_layers > 0:
        frames = torch.randn((batch, cfg.n_prefix, cfg.d_model),
                             generator=gen, device=dev).to(cfg.dtype) * 0.1
        extras["enc_frames"] = frames
        memory_kv = lm.make_cross_kv(cfg, params, lm.encode(cfg, params,
                                                            frames))
    elif cfg.n_prefix > 0:
        extras["prefix_embeds"] = torch.randn(
            (batch, cfg.n_prefix, cfg.d_model), generator=gen,
            device=dev).to(cfg.dtype) * 0.1
        n_prefix = cfg.n_prefix

    max_len = prompt_len + n_prefix + max_new
    cache = lm.init_cache(cfg, batch, max_len, device=dev)
    prefill = bayes_lm.make_prefill_step(cfg)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompts, cache, **extras)
        first = torch.argmax(logits[:, -1, :].float(), -1)
        first = first.to(torch.int32)[:, None]
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        # the decode loop's buffers, written in place by the step program
        out_tokens = torch.empty((batch, max_new), dtype=torch.int32,
                                 device=dev)
        out_tokens[:, :1] = first
        token = first.clone()
        pos = torch.full((batch,), prompt_len + n_prefix, dtype=torch.int32,
                         device=dev)
        idx = torch.ones((1,), dtype=torch.int64, device=dev)
        step = decode_program(cfg, temperature)
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            step(params, token, cache, pos, out_tokens, idx, gen, memory_kv)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    generated = out_tokens.cpu()
    n_steps = max(max_new - 1, 1)
    stats = {
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / n_steps,
        "tokens_per_s": batch * (max_new - 1) / t_decode if t_decode else 0.0,
        "tokens": generated.numpy(),
    }
    return generated, stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=configs.ARCH_NAMES,
                   help="LM serving path (required unless --queries)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--queries", action="store_true",
                   help="serve probability queries (not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.queries:
        raise NotImplementedError("the probability-query server is not "
                                  "ported yet (ROADMAP Queue 1 item 6)")
    if args.arch is None:
        p.error("--arch is required unless --queries is given")
    gen, stats = serve_batch(args.arch, smoke=args.smoke, batch=args.batch,
                             prompt_len=args.prompt_len, max_new=args.max_new,
                             temperature=args.temperature, seed=args.seed,
                             device=args.device)
    print(f"[serve] prefill {stats['prefill_s']:.3f}s, "
          f"decode {stats['decode_s_per_token'] * 1e3:.1f} ms/token")
    print(f"[serve] generated shape {tuple(gen.shape)}; "
          f"first row: {np.asarray(gen)[0][:12]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
