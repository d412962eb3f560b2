"""MAP estimation (posterior mode) via Adam on the unconstrained space."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.contexts import Context
from repro_torch.core.model import Model
from repro_torch.core.program import (CompiledProgram, ProgramKey,
                                      model_fingerprint, write_into)
from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.optim import adam, apply_updates

__all__ = ["MAP"]


@dataclasses.dataclass
class MAP:
    lr: float = 0.05
    num_steps: int = 500

    def run(self, seed: int, m: Model, ctx: Optional[Context] = None,
            init_varinfo: Optional[TypedVarInfo] = None, device=None):
        """``(estimate, losses)``: the mode as constrained values by site
        name, and the negative log-density at each step. Starts at 0 in
        the unconstrained space (Stan-style init); the discovery draw
        (only the layout is used) comes from a ``torch.Generator`` seeded
        with ``seed`` on ``device`` (``None`` means CUDA)."""
        dev = resolve_device(device)
        tvi = (init_varinfo if init_varinfo is not None
               else m.typed_varinfo(
                   torch.Generator(device=dev).manual_seed(int(seed))))
        tvi = tvi.link()
        logdensity = m.make_logdensity_fn(tvi, ctx=ctx)
        loss_and_grad = torch.func.grad_and_value(lambda u: -logdensity(u))
        opt = adam(self.lr)
        q = torch.zeros_like(tvi.flat())
        state = opt.init(q)
        losses = torch.empty(self.num_steps, dtype=torch.float32,
                             device=q.device)
        idx = torch.zeros((1,), dtype=torch.int64, device=q.device)

        def raw_step(q, state, losses, idx):
            grad, loss = loss_and_grad(q)
            deltas, new_state = opt.update(grad, state, q)
            write_into((q, state), (apply_updates(q, deltas), new_state))
            losses.index_copy_(0, idx, loss.reshape(1).to(torch.float32))
            idx.add_(1)

        # one program a run, over this run's buffers (written in place): on
        # CUDA each step after the second is one graph replay, as repro
        # jits the step
        step = CompiledProgram(
            ProgramKey(model_fingerprint(m), "map_step", tvi.layout, (),
                       "fused", (float(self.lr),)),
            raw_step, donate_argnums=(0, 1, 2, 3))
        for _ in range(self.num_steps):
            step(q, state, losses, idx)
        estimate = tvi.replace_flat(q).invlink().as_dict()
        return estimate, losses.cpu().numpy()
