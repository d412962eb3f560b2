#!/usr/bin/env python3
"""granite-moe-1b-a400m's float32 serving routes against float64, on the card.

    python3 probes/moe_float64_anchor.py

Serves granite-moe-1b-a400m at full width and depth (24 layers, random
weights from seed 0, 8 requests x prompt 1,024 + 64 new tokens, the
serving path's prompts) in float32 through the flash kernels and through
the dense route on the same tokens, and through the dense route in
float64, at the default capacity and at capacity E / k. Prints, for each
capacity, how many tokens the two float32 routes send to other experts
(and the float32 dense route against the float64 one), the range over
the 64 steps of each step's largest logit difference (flash against
dense, each against float64) and of its largest |logit|, and those of
some steps. The card's name and power limit come first. Needs ``chip_smoke.py`` beside it (the kernels' build and the
serving path's helpers).
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import bayes_lm  # noqa: E402
from repro_torch.nn import lm, moe  # noqa: E402

STEPS_SHOWN = (0, 1, 2, 31, 62)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_float64_anchor: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    cs.build_all({cs.FLASH_CU: fops._lib})
    arch = "granite-moe-1b-a400m"
    batch, prompt_len, max_new, _ = cs.MOE_SERVE[arch]
    cfg = dataclasses.replace(configs.get_config(arch), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device="cuda")
    params = lm.init_params(cfg, seed=0, device="cuda")
    routes = []
    route = moe._route

    def recorded(*args, **kwargs):
        vals, idx = route(*args, **kwargs)
        routes.append(idx.clone())
        return vals, idx

    moe._route = recorded

    def run(c, p, feed=None):
        routes.clear()
        steps, tokens = cs.greedy_run(torch, lm, bayes_lm, c, p, prompts,
                                      max_new, feed=feed)
        return steps, tokens, list(routes)

    def moved(a, b):
        return sum(int((x.sort(-1)[0] != y.sort(-1)[0]).any(-1).sum())
                   for x, y in zip(a, b))

    for factor in (cfg.capacity_factor, cfg.n_experts / cfg.top_k):
        c32 = dataclasses.replace(cfg, dtype=torch.float32,
                                  capacity_factor=float(factor))
        p32 = lm.tree_map(lambda t: t.float(), params)
        flash, ftok, r_flash = run(c32, p32)
        dense, _, r_dense = run(dataclasses.replace(c32, attn_impl="xla"),
                                p32, ftok)
        p64 = lm.tree_map(lambda t: t.double(), params)
        exact, _, r_64 = run(dataclasses.replace(c32, dtype=torch.float64,
                                                 attn_impl="xla"), p64, ftok)
        del p64
        print(f"capacity factor {factor:g}: tokens routed to other experts, "
              f"flash / dense float32 {moved(r_flash, r_dense)}, dense "
              f"float32 / float64 {moved(r_dense, r_64)} (of "
              f"{sum(r.shape[0] for r in r_flash)} routed tokens)",
              flush=True)
        rows = []
        for a, b, e in zip(flash, dense, exact):
            e = e.float()
            rows.append((float((a - b).abs().max()),
                         float((a - e).abs().max()),
                         float((b - e).abs().max()), float(e.abs().max())))
        names = ("flash-dense", "flash-float64", "dense-float64",
                 "|logit|")
        print(" over the steps, max |d| " + "; ".join(
            f"{n} {min(c):.3e}-{max(c):.3e}" for n, c in
            zip(names, zip(*rows))), flush=True)
        for i in STEPS_SHOWN:
            print(f" step {i}: max |d| " + "; ".join(
                f"{n} {v:.3e}" for n, v in zip(names, rows[i])), flush=True)
        del flash, dense, exact, p32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
