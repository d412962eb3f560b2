"""Separable linked-space potential IR for the fused leapfrog kernel.

A model whose linked-space log-density decomposes as

    logp(u) = sum_i  v_op[i](u[i]; c0[i], c1[i], c2[i], c3[i]) + const

is *separable*: every coordinate contributes an independent elementwise
term, so the potential value AND its gradient are pure elementwise maps,
and the whole n-step leapfrog is one kernel launch with no autodiff.

Opcodes (u = unconstrained coordinate; link jacobians are folded into the
coefficients by ``repro_torch.core.potential``):

======== ============ ====================================================
opcode    name         v(u)
======== ============ ====================================================
0         ZERO         0
1         NORMAL       -0.5 * ((u - c0) * c1)**2
2         EXP          c0*u - c1*exp(c2*u)
3         SOFTPLUS     -c0*softplus(-u) - c1*softplus(u)
4         TLOG         -c0*log1p(c1*((u - c2)*c3)**2)
======== ============ ====================================================

All c1 slots are nonnegative by construction (1/scale, rate, 1/df, ...),
so evaluating every branch and selecting with ``torch.where`` is NaN-free.

The conditionally separable extension (``CondPotentialSpec``) is not
ported yet (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "OP_ZERO", "OP_NORMAL", "OP_EXP", "OP_SOFTPLUS", "OP_TLOG", "N_OPS",
    "PotentialSpec", "potential_elem_value", "potential_elem_grad",
]

OP_ZERO = 0
OP_NORMAL = 1
OP_EXP = 2
OP_SOFTPLUS = 3
OP_TLOG = 4
N_OPS = 5


@dataclasses.dataclass(frozen=True, eq=False)
class PotentialSpec:
    """Compiled separable potential over a flat unconstrained vector.

    ``op``/``c0``..``c3`` are NumPy int32/float32 arrays of length ``dim``
    (compile-time constants). ``const`` collects every u-independent term.
    ``uniform_op`` is set when all coordinates share one opcode, which
    selects the kernel instantiation without the per-element switch.
    """

    op: np.ndarray
    c0: np.ndarray
    c1: np.ndarray
    c2: np.ndarray
    c3: np.ndarray
    const: float
    dim: int
    uniform_op: Optional[int] = None
    _on_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = \
        dataclasses.field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "op", np.asarray(self.op, np.int32))
        for f in ("c0", "c1", "c2", "c3"):
            object.__setattr__(self, f, np.asarray(getattr(self, f),
                                                   np.float32))
        ops = np.unique(self.op)
        uop = int(ops[0]) if len(ops) == 1 else None
        object.__setattr__(self, "uniform_op", uop)

    def coeff_arrays(self, device=None) -> Tuple[torch.Tensor, ...]:
        """``(op, c0, c1, c2, c3)`` as tensors on ``device`` (default the
        CPU). Each device gets its copy once: a transition never copies
        host data to the card."""
        dev = torch.device("cpu" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in self._on_device:
            self._on_device[dev] = tuple(
                torch.tensor(a, device=dev)
                for a in (self.op, self.c0, self.c1, self.c2, self.c3))
        return self._on_device[dev]


def _v_normal(u, c0, c1, c2, c3):
    z = (u - c0) * c1
    return -0.5 * z * z


def _g_normal(u, c0, c1, c2, c3):
    return -(u - c0) * (c1 * c1)


def _v_exp(u, c0, c1, c2, c3):
    return c0 * u - c1 * torch.exp(c2 * u)


def _g_exp(u, c0, c1, c2, c3):
    return c0 - c1 * c2 * torch.exp(c2 * u)


def _softplus(x):
    # log1p(exp(-|x|)) + max(x, 0): stable for large |x|
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def _v_softplus(u, c0, c1, c2, c3):
    return -c0 * _softplus(-u) - c1 * _softplus(u)


def _g_softplus(u, c0, c1, c2, c3):
    return c0 * torch.sigmoid(-u) - c1 * torch.sigmoid(u)


def _v_tlog(u, c0, c1, c2, c3):
    zt = (u - c2) * c3
    return -c0 * torch.log1p(c1 * zt * zt)


def _g_tlog(u, c0, c1, c2, c3):
    zt = (u - c2) * c3
    return -2.0 * c0 * c1 * zt * c3 / (1.0 + c1 * zt * zt)


def _zeros(u, c0, c1, c2, c3):
    return torch.zeros_like(u)


_VALUE_FNS = {OP_ZERO: _zeros, OP_NORMAL: _v_normal, OP_EXP: _v_exp,
              OP_SOFTPLUS: _v_softplus, OP_TLOG: _v_tlog}
_GRAD_FNS = {OP_ZERO: _zeros, OP_NORMAL: _g_normal, OP_EXP: _g_exp,
             OP_SOFTPLUS: _g_softplus, OP_TLOG: _g_tlog}


def _dispatch(fns, op, uniform_op, u, c0, c1, c2, c3):
    if uniform_op is not None:
        return fns[uniform_op](u, c0, c1, c2, c3)
    out = torch.zeros_like(u)
    for code in (OP_NORMAL, OP_EXP, OP_SOFTPLUS, OP_TLOG):
        out = torch.where(op == code, fns[code](u, c0, c1, c2, c3), out)
    return out


def potential_elem_value(op, c0, c1, c2, c3, u, *, uniform_op=None):
    """Per-coordinate potential values v_op(u); same shape as ``u``."""
    return _dispatch(_VALUE_FNS, op, uniform_op, u, c0, c1, c2, c3)


def potential_elem_grad(op, c0, c1, c2, c3, u, *, uniform_op=None):
    """Per-coordinate potential gradients dv/du; same shape as ``u``."""
    return _dispatch(_GRAD_FNS, op, uniform_op, u, c0, c1, c2, c3)
