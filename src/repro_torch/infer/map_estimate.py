"""MAP estimation (posterior mode) via Adam on the unconstrained space."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.contexts import Context
from repro_torch.core.model import Model
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

        losses = []
        for _ in range(self.num_steps):
            grad, loss = loss_and_grad(q)
            deltas, state = opt.update(grad, state, q)
            q = apply_updates(q, deltas)
            losses.append(loss)
        estimate = tvi.replace_flat(q).invlink().as_dict()
        return estimate, np.asarray([float(x) for x in losses], np.float32)
