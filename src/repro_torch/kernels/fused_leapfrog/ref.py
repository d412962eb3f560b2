"""Plain PyTorch versions of the fused leapfrog kernels.

``leapfrog_ref`` repeats ``repro_torch.infer.hmc._leapfrog``'s arithmetic
step for step (same velocity-Verlet ordering, potential at the final
position), with the gradient taken from the separable
:class:`PotentialSpec` analytically: no autodiff anywhere. The CPU path of
every wrapper in ``ops.py`` runs these, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.

Shapes: ``q``, ``p``, ``grad`` are ``(dim,)`` or ``(num_chains, dim)``;
``step_size`` is a number, a 0-d tensor or a per-chain ``(num_chains,)``
tensor; ``inv_mass`` is an optional diagonal ``(dim,)``.

``leapfrog_cond_ref`` is the integrator of a :class:`CondPotentialSpec`
on every device, as ``repro``'s is jnp on every backend: its head term
replays model code, which no generic kernel absorbs. Its chains run under
``torch.func.vmap``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_leapfrog.spec import (
    N_OPS, OP_EXP, OP_NORMAL, OP_SOFTPLUS, OP_TLOG, CondPotentialSpec,
    PotentialSpec, cond_potential_value_and_grad, potential_elem_grad,
    potential_elem_value)

__all__ = ["potential_value_and_grad_ref", "leapfrog_ref", "random_spec",
           "cond_value_and_grad", "leapfrog_cond_ref"]


def _const(spec: PotentialSpec) -> float:
    """``spec.const`` rounded to float32, added after the sum."""
    return float(np.float32(spec.const))


def potential_value_and_grad_ref(spec: PotentialSpec, u: torch.Tensor):
    """Analytic ``(logp, dlogp/du)`` of the compiled potential at ``u``;
    ``logp`` has ``u``'s shape without its last axis."""
    op, c0, c1, c2, c3 = spec.coeff_arrays(u.device)
    u = u.to(torch.float32)
    v = potential_elem_value(op, c0, c1, c2, c3, u,
                             uniform_op=spec.uniform_op)
    g = potential_elem_grad(op, c0, c1, c2, c3, u,
                            uniform_op=spec.uniform_op)
    return torch.sum(v, dim=-1) + _const(spec), g


def leapfrog_ref(spec: PotentialSpec, q, p, grad, step_size, n_steps: int,
                 inv_mass=None):
    """n-step leapfrog on the separable potential. Returns
    ``(q, p, logp, grad)``; ``logp`` is the potential (with
    ``spec.const``) at the final position."""
    op, c0, c1, c2, c3 = spec.coeff_arrays(q.device)
    uop = spec.uniform_op
    eps = step_size
    if torch.is_tensor(eps) and eps.dim() == q.dim() - 1 and eps.dim() > 0:
        eps = eps.unsqueeze(-1)  # per-chain step broadcast over dim
    for _ in range(n_steps):
        p_half = p + 0.5 * eps * grad
        vel = p_half if inv_mass is None else inv_mass * p_half
        q = q + eps * vel
        grad = potential_elem_grad(op, c0, c1, c2, c3, q, uniform_op=uop)
        p = p_half + 0.5 * eps * grad
    v = potential_elem_value(op, c0, c1, c2, c3, q, uniform_op=uop)
    return q, p, torch.sum(v, dim=-1) + _const(spec), grad


def cond_value_and_grad(spec: CondPotentialSpec, u: torch.Tensor):
    """:func:`cond_potential_value_and_grad` of ``u`` (``(dim,)``) or of
    each chain of ``u`` (``(num_chains, dim)``, under ``torch.func.vmap``)."""
    if u.dim() == 1:
        return cond_potential_value_and_grad(spec, u)
    return torch.func.vmap(
        lambda r: cond_potential_value_and_grad(spec, r))(u)


def leapfrog_cond_ref(spec: CondPotentialSpec, q, p, grad, step_size,
                      n_steps: int, inv_mass=None):
    """n-step leapfrog on a conditionally separable potential.

    Same step ordering as :func:`leapfrog_ref`; the density/gradient come
    from :func:`cond_value_and_grad` — leaf terms analytic elementwise,
    only the small head block goes through autodiff of the auxiliary
    coefficient function. Returns ``(q, p, logp, grad)``, ``logp`` at the
    final position."""
    eps = step_size
    if torch.is_tensor(eps) and eps.dim() == q.dim() - 1 and eps.dim() > 0:
        eps = eps.unsqueeze(-1)  # per-chain step broadcast over dim
    logp = None
    for _ in range(n_steps):
        p_half = p + 0.5 * eps * grad
        vel = p_half if inv_mass is None else inv_mass * p_half
        q = q + eps * vel
        logp, grad = cond_value_and_grad(spec, q)
        p = p_half + 0.5 * eps * grad
    if logp is None:  # no step: the potential at the start
        logp = cond_value_and_grad(spec, q)[0]
    return q, p, logp, grad


def random_spec(dim: int, uniform_op=None, seed: int = 0,
                run: int = 1) -> PotentialSpec:
    """A random opcode table for checking the kernels against this module,
    with the coefficient forms the compiler folds: Normal (loc, 1/scale),
    Gamma-like EXP (a, b, 1), Beta-like SOFTPLUS (a, b) and StudentT-like
    TLOG ((df+1)/2, 1/df, loc, 1/scale); every c1 >= 0. ``uniform_op=None``
    mixes all five opcodes, one drawn for each ``run`` coordinates (512
    gives family_mix_8k's layout, where a site's coordinates share one)."""
    rng = np.random.default_rng(seed)
    op = (rng.integers(0, N_OPS, -(-dim // run)).repeat(run)[:dim]
          if uniform_op is None else np.full(dim, uniform_op))
    c = np.zeros((4, dim))
    normal, exp, sp, tl = (op == k for k in (OP_NORMAL, OP_EXP, OP_SOFTPLUS,
                                             OP_TLOG))
    c[0, normal] = rng.normal(size=normal.sum())
    c[1, normal] = 1.0 / rng.uniform(0.5, 2.0, normal.sum())
    c[0, exp] = rng.uniform(1.0, 3.0, exp.sum())
    c[1, exp] = rng.uniform(0.5, 2.0, exp.sum())
    c[2, exp] = 1.0
    c[0, sp] = rng.uniform(1.0, 3.0, sp.sum())
    c[1, sp] = rng.uniform(1.0, 3.0, sp.sum())
    df = rng.uniform(2.0, 8.0, tl.sum())
    c[0, tl], c[1, tl] = (df + 1.0) / 2.0, 1.0 / df
    c[2, tl] = rng.normal(size=tl.sum())
    c[3, tl] = 1.0 / rng.uniform(0.5, 2.0, tl.sum())
    return PotentialSpec(op=op, c0=c[0], c1=c[1], c2=c[2], c3=c[3],
                         const=-1.25, dim=dim)
