"""Batched-request serving drivers: LM decode and probability queries, as
``repro.launch.serve``.

**LM path.** ``serve_batch`` groups requests into a fixed batch: one prefill over the
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

**Query path** (``QueryServer``): heterogeneous ``prob`` requests are
lowered through :func:`repro_torch.core.queries.prepare_query`, grouped
by program-cache key (model x query kind x shape signature), padded to a
power-of-two lane count by repeating the last lane, and evaluated as ONE
``torch.func.vmap`` of the per-request program a group, cached under the
``"<kind>/batched"`` key (one CUDA graph a bucket on the card). A
posterior predictive inside it vmaps again over its M draws, and the
density kernels take lanes x draws as the rows of one launch.
Latency/throughput/padding counters ride along.

Usage:
  python -m repro_torch.launch.serve --arch smollm-360m --smoke \\
      --batch 4 --prompt-len 32 --max-new 16 [--device cpu]
  python -m repro_torch.launch.serve --queries --requests 32 [--device cpu]

The route (dense attention or the kernels) is the config's ``attn_impl``,
as in the JAX package; ``serve_batch(cfg=dataclasses.replace(cfg,
attn_impl="flash"))`` selects the kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.core.program import (CompiledProgram, ProgramKey,
                                      program_cache)
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


# ---------------------------------------------------------------------------
# Probability-query serving
# ---------------------------------------------------------------------------
def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class QueryServerStats:
    """Counters for one ``QueryServer`` lifetime."""

    requests: int = 0
    batches: int = 0
    groups: int = 0            # distinct cache keys seen
    padded_lanes: int = 0      # wasted (padding) evaluations
    latency_s: float = 0.0     # wall time spent evaluating batches
    cache_hits: int = 0        # program-cache hits while serving
    cache_misses: int = 0      # programs built on behalf of requests

    @property
    def throughput_qps(self) -> float:
        return self.requests / self.latency_s if self.latency_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "requests": self.requests, "batches": self.batches,
            "groups": self.groups, "padded_lanes": self.padded_lanes,
            "latency_s": self.latency_s,
            "throughput_qps": self.throughput_qps,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
        }


class QueryServer:
    """Batch heterogeneous ``prob`` requests into padded vmapped programs.

    Requests are (spec, bindings) pairs. Each is lowered with
    ``prepare_query`` on ``device`` (``None`` means CUDA); requests
    sharing a program-cache key (same model, query kind, shape signature)
    are stacked into one batch, padded to the next power-of-two lane count
    by repeating the last lane (so a trickle of odd batch sizes builds a
    handful of bucket programs, not one per size), and evaluated by a
    cached ``vmap`` of the per-request program. ``latency_s`` is the wall
    time of ``serve`` calls, synchronised with the card.
    """

    def __init__(self, cache=None, device=None):
        self.cache = cache if cache is not None else program_cache()
        self.device = resolve_device(device)
        self.stats = QueryServerStats()
        self._seen_keys = set()

    def _batched_program(self, pq, bucket: int) -> CompiledProgram:
        """Cached vmap of ``pq``'s raw program over ``bucket`` lanes."""
        k = pq.key
        bkey = ProgramKey(k.model, k.kind + "/batched", k.layout,
                          k.batch + (bucket,), k.backend, k.extra)
        return self.cache.get_or_build(
            bkey, lambda: CompiledProgram(bkey, torch.func.vmap(pq.program.raw),
                                          jit=pq.program.jit))

    def serve(self, requests: Sequence[Tuple[str, Dict[str, Any]]]
              ) -> List[torch.Tensor]:
        """Evaluate a batch of (spec, bindings) requests.

        Returns per-request log probabilities (0-d tensors on the device)
        in request order; updates the latency/throughput/padding counters.
        """
        from repro_torch.core.queries import prepare_query

        cstats0 = self.cache.stats()
        _sync(self.device)
        t0 = time.perf_counter()
        prepared = [prepare_query(spec, dict(b), cache=self.cache,
                                  device=self.device)
                    for spec, b in requests]

        groups: Dict[Any, List[int]] = {}
        for i, pq in enumerate(prepared):
            groups.setdefault(pq.key, []).append(i)

        results: List[Optional[torch.Tensor]] = [None] * len(prepared)
        for key, idxs in groups.items():
            self._seen_keys.add(key)
            bucket = _next_pow2(len(idxs))
            pad = bucket - len(idxs)
            # pad by repeating the last request's lane; padded lanes are
            # computed then dropped
            lanes = idxs + [idxs[-1]] * pad
            n_args = len(prepared[idxs[0]].args)
            stacked = tuple(
                torch.stack([prepared[i].args[j] for i in lanes])
                for j in range(n_args))
            out = self._batched_program(prepared[idxs[0]], bucket)(*stacked)
            for lane, i in enumerate(idxs):
                results[i] = out[lane]
            self.stats.padded_lanes += pad
        _sync(self.device)

        self.stats.latency_s += time.perf_counter() - t0
        self.stats.requests += len(requests)
        self.stats.batches += 1
        self.stats.groups = len(self._seen_keys)
        cstats1 = self.cache.stats()
        self.stats.cache_hits += max(0, cstats1["hits"] - cstats0["hits"])
        self.stats.cache_misses += max(
            0, cstats1["misses"] - cstats0["misses"])
        return results


def _demo_query_requests(num_requests: int, seed: int = 0):
    """Heterogeneous demo workload over a small linear-regression model.

    The data are NumPy arrays from ``np.random.default_rng(seed)``, the
    same as ``repro``'s demo draws; the model's prior parameters sit on
    the device of the data it is bound to."""
    from repro_torch import model, observe, sample
    from repro_torch.dists import InverseGamma, MvNormalDiag, Normal

    @model
    def linreg(X, y):
        w = sample("w", MvNormalDiag(torch.zeros(3, device=X.device),
                                     torch.ones(3, device=X.device)))
        s = sample("s", InverseGamma(2.0, 3.0))
        observe("y", Normal(X @ w, torch.sqrt(s)), y)

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(num_requests):
        X = rng.normal(size=(4, 3)).astype(np.float32)
        y = rng.normal(size=(4,)).astype(np.float32)
        w = rng.normal(size=(3,)).astype(np.float32)
        if i % 3 == 2:  # every third request: posterior predictive
            chain = {"w": rng.normal(size=(8, 3)).astype(np.float32),
                     "s": np.ones(8, np.float32)}
            reqs.append(("X = Xn, y = yn | chain = c, model = m",
                         {"Xn": X, "yn": y, "c": chain, "m": linreg}))
        elif i % 3 == 1:  # prior query (data as program inputs so
            # requests with different content share one program)
            reqs.append(("w = w0, s = 1.0 | X = Xn, y = yn, model = m",
                         {"Xn": X, "yn": y, "w0": w, "m": linreg}))
        else:  # likelihood query
            reqs.append(("X = Xn, y = yn | w = w0, s = 1.0, model = m",
                         {"Xn": X, "yn": y, "w0": w, "m": linreg}))
    return reqs


def serve_queries(num_requests: int = 32, batch: int = 8, seed: int = 0,
                  device=None) -> QueryServerStats:
    """CLI/CI entry: run the demo workload through a ``QueryServer`` on
    ``device`` (``None`` means CUDA)."""
    server = QueryServer(device=device)
    reqs = _demo_query_requests(num_requests, seed=seed)
    for off in range(0, len(reqs), batch):
        server.serve(reqs[off:off + batch])
    return server.stats


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
                   help="serve batched probability queries instead of LM")
    p.add_argument("--requests", type=int, default=32,
                   help="(--queries) number of demo requests")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.queries:
        stats = serve_queries(num_requests=args.requests,
                              batch=args.batch if args.batch > 0 else 8,
                              seed=args.seed, device=args.device)
        d = stats.as_dict()
        print(f"[serve] {d['requests']} queries in {d['batches']} batches "
              f"({d['groups']} program groups, {d['padded_lanes']} padded "
              f"lanes)")
        print(f"[serve] latency {d['latency_s']:.3f}s total, "
              f"{d['throughput_qps']:.1f} queries/s; program cache "
              f"{d['cache_hits']} hit(s) / {d['cache_misses']} miss(es)")
        return 0
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
