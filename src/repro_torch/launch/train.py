"""End-to-end Bayesian-LM training driver, as ``repro.launch.train``.

Wires the substrate layers together: configs -> data pipeline
(``SyntheticTokens``) -> DynamicPPL log-joint (``MiniBatchContext``) ->
MAP-AdamW / SGLD step (``bayes_lm.make_train_step``: one cached program,
a CUDA graph from its second call on the card, the state written in
place) -> async checkpointing -> fault tolerance (preemption flag,
straggler monitor) -> auto-resume from the latest checkpoint.

Runs on the card unless the caller passes ``device="cpu"`` (``--device
cpu``). Training on a mesh of ranks is not ported (ROADMAP Queue 1 item
12): ``mesh_shape`` that a world of enough ranks could hold raises.

Usage:
  python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir <dir> [--mode map|sgld] \\
      [--device cpu]
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
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.data import SyntheticTokens
from repro_torch.models import bayes_lm
from repro_torch.nn import lm
from repro_torch.runtime import PreemptionHandler, StragglerDetector
from repro_torch.sharding.mesh import Mesh

__all__ = ["make_mesh_or_none", "train", "main"]

_MESH_LATER = "ROADMAP Queue 1 item 12"


def make_mesh_or_none(data: int, model: int) -> Optional[Mesh]:
    """A (data, model) mesh of the world's first ``data * model`` ranks, or
    None when the world (one process without ``torch.distributed``) has
    fewer ranks, as ``repro``'s counts ``jax.devices()``."""
    dist = torch.distributed
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if data * model > n:
        return None  # single-device path: no mesh, no rules
    return Mesh(np.arange(data * model).reshape(data, model),
                ("data", "model"))


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 128, mode: str = "map",
          lr: float = 3e-4, microbatch: int = 1, ckpt_dir: str = "",
          ckpt_every: int = 50, keep: int = 3, seed: int = 0,
          mesh_shape: Optional[tuple] = None, log_every: int = 10,
          preempt: Optional[PreemptionHandler] = None, device=None,
          cfg: Optional[lm.ArchConfig] = None):
    """Train ``arch`` for ``steps`` steps; returns (state, history), the
    history holding ``(step, nll)`` at each logged step. ``cfg`` replaces
    the registry's config (a route or depth of the caller's choosing)."""
    device = resolve_device(device)
    if cfg is None:
        cfg = (configs.get_smoke_config(arch) if smoke
               else configs.get_config(arch))
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=seed, device=device)
    init_fn, step_fn = bayes_lm.make_train_step(
        cfg, total_tokens=float(steps * batch * seq), mode=mode,
        learning_rate=lr, microbatch=microbatch)

    # a mesh of one rank is the single-device path
    mesh = make_mesh_or_none(*mesh_shape) if mesh_shape else None
    if mesh is not None and mesh.devices.size > 1:
        raise NotImplementedError(
            f"training on a mesh of ranks ({mesh.shape}) is not ported yet "
            f"({_MESH_LATER})")

    params = lm.init_params(cfg, seed=seed, device=device)
    state = init_fn(params)
    start = 0

    ckpt = AsyncCheckpointer(ckpt_dir, keep=keep) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start, state = restore(ckpt_dir, target=state)
        print(f"[train] resumed from step {start}", flush=True)

    preempt = preempt or PreemptionHandler(install=False)
    straggler = StragglerDetector(num_hosts=1)
    # SGLD's noise: its own stream, as repro's PRNGKey(seed + 1)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    history = []
    t_last = time.perf_counter()
    for step in range(start, steps):
        state, metrics = step_fn(state, gen, data.batch(step))
        if (step + 1) % log_every == 0 or step + 1 == steps:
            m = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            straggler.record_step({0: now - t_last})
            t_last = now
            history.append((step + 1, m["nll"]))
            print(f"[train] step {step + 1}/{steps} "
                  f"nll/token {m['nll']:.4f} "
                  f"logjoint {m['logjoint']:.3e} "
                  f"gnorm {m['grad_norm']:.2f}", flush=True)
        if ckpt and ((step + 1) % ckpt_every == 0 or step + 1 == steps):
            ckpt.save(step + 1, state)
        if preempt.preempted:
            print("[train] preemption: final checkpoint + exit", flush=True)
            if ckpt:
                ckpt.save(step + 1, state)
                ckpt.wait()
            return state, history
    if ckpt:
        ckpt.wait()
    return state, history


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-feasible)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--mode", default="map", choices=("map", "sgld"))
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatch", type=int, default=1)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    # context manager: SIGTERM/SIGINT handlers are restored on exit even
    # if train() raises, so embedding callers keep their own handlers
    with PreemptionHandler() as preempt:
        _, history = train(args.arch, smoke=args.smoke, steps=args.steps,
                           batch=args.batch, seq=args.seq, mode=args.mode,
                           lr=args.lr, microbatch=args.microbatch,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           seed=args.seed, log_every=args.log_every,
                           preempt=preempt, device=args.device)
    if len(history) >= 2 and history[-1][1] >= history[0][1]:
        print("[train] WARNING: nll did not improve", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
