"""Self-contained optimisers: SGD, Adam, AdamW, as ``repro.optim``.

Used by MAP inference and ADVI. Each optimiser is a pair of plain
functions (init, update) over trees of tensors (tuples, lists, dicts and
NamedTuples, through ``torch.utils._pytree``), not ``torch.optim``, so
that the update order and arithmetic are ``repro``'s: the same float32
expressions in the same order give the same bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["Optimizer", "sgd", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def global_norm(tree) -> torch.Tensor:
    leaves, _ = tree_flatten(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        del params
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


class _AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam; with weight_decay > 0 this is AdamW (decoupled decay)."""

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        leaves, _ = tree_flatten(params)
        dev = leaves[0].device if leaves else None
        return _AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(zeros, params), tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        t = step.to(torch.float32)
        # the bases as device fills, not host copies: a captured step
        # cannot hold a host-to-device copy
        b1t = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                         device=t.device), t)
        b2t = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                         device=t.device), t)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m_new = b1 * m + (1.0 - b1) * g32
            v_new = b2 * v + (1.0 - b2) * torch.square(g32)
            mhat = m_new / b1t
            vhat = v_new / b2t
            delta = -lr * (mhat / (torch.sqrt(vhat) + eps)
                           + weight_decay * p.to(torch.float32))
            return delta.to(p.dtype), m_new, v_new

        flat_g, spec = tree_flatten(grads)
        flat_m, _ = tree_flatten(state.mu)
        flat_v, _ = tree_flatten(state.nu)
        flat_p, _ = tree_flatten(params)
        out = [upd(g, m, v, p)
               for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p)]
        deltas = tree_unflatten([o[0] for o in out], spec)
        mu = tree_unflatten([o[1] for o in out], spec)
        nu = tree_unflatten([o[2] for o in out], spec)
        return deltas, _AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def apply_updates(params, deltas):
    return tree_map(lambda p, d: p + d.to(p.dtype), params, deltas)
