"""Static HMC — the paper's benchmark algorithm (§4: 4 leapfrog steps).

The state of every chain is written out as ``(num_chains, dim)``. The
log-density's value and gradient run under
``torch.func.vmap(torch.func.grad_and_value(...))`` over the chain axis,
so each density family in the fused log-joint is ONE kernel launch for
all chains per leapfrog step. Momentum and accept-uniform draws come from
one explicit ``torch.Generator`` on the chains' device (they will never
equal the JAX package's threefry draws; the tests inject the same NumPy
momentum into both packages' ``_leapfrog`` instead).

``leapfrog="auto"`` compiles the model's linked density
(``core/potential.py``): to a separable ``PotentialSpec`` (gaussian_10k),
whose integrator is one ``fused_leapfrog`` launch per transition for all
chains, analytic gradients, no autodiff; or to a ``CondPotentialSpec``
(eight_schools, gauss_unknown), whose leaves stay analytic and whose
small head goes through autodiff of a model replay, in plain torch under
``torch.func.vmap`` over the chains. When the compiler rejects the model
(logreg, naive_bayes, hier_poisson, ...) it runs the autodiff integrator
and keeps the compiler's reason on ``TransitionKernel.spec_reason``.
``"fused"`` demands a spec and raises ``ValueError`` with that reason;
``"reference"`` always runs autodiff.

Two execution paths, mirroring the paper's central comparison:

* ``run`` — TYPED path: the log-density is specialised on the
  TypedVarInfo (the fused evaluator, one kernel launch per density family
  for all chains), taken from the program cache through ``run_chains``,
  whose transitions are programs (on the card, CUDA graph replays);
* ``run_untyped`` — UNTYPED path: a NumPy loop in which every evaluation
  replays the model eagerly through the per-site evaluator, with autograd
  for the gradient and a host round trip per evaluation, the analogue of
  ``Vector{Real}`` and dynamic dispatch that the paper's typed traces
  remove.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.contexts import Context, DefaultContext
from repro_torch.core.model import Model
from repro_torch.core.varinfo import TypedVarInfo, assert_continuous_supports
from repro_torch.kernels.fused_leapfrog.spec import (CondPotentialSpec,
                                                     PotentialSpec)
from repro_torch.core.program import ProgramKey
from repro_torch.infer.chains import (Chain, TransitionKernel,
                                      TransitionPrograms, package_draws,
                                      run_chains)
from repro_torch.kernels.fused_leapfrog.ops import (fused_leapfrog,
                                                    potential_value_and_grad)

__all__ = ["HMC", "DualAveraging", "hmc_transition", "make_chain_fn",
           "value_and_grad"]


def value_and_grad(logdensity: Callable) -> Callable:
    """``q -> (logp, grad)`` for ``q (dim,)`` or a chain batch
    ``q (num_chains, dim)``; the batch runs under ``torch.func.vmap``."""
    g_and_v = torch.func.grad_and_value(logdensity)

    def single(q):
        grad, val = g_and_v(q)
        return val, grad

    batched = torch.func.vmap(single)

    def f(q):
        if q.dim() == 1:
            return single(q)
        if q.dim() == 2:
            return batched(q)
        raise ValueError(f"expected q of shape (dim,) or (chains, dim), "
                         f"got {tuple(q.shape)}")

    return f


@dataclasses.dataclass(frozen=True)
class DualAveraging:
    """Nesterov dual-averaging step-size adaptation (Stan warmup), applied
    elementwise to per-chain tensors. The iteration ``t`` is a float32
    tensor, as ``repro`` feeds it (``jnp.arange(num_warmup, float32)``), so
    a captured warmup transition reads it from the device."""

    target_accept: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75

    def init(self, step_size):
        eps = torch.as_tensor(step_size, dtype=torch.float32)
        zero = torch.zeros_like(eps)
        return (torch.log(eps), zero, zero, torch.log(10.0 * eps))

    def update(self, state, accept_prob, t):
        log_eps, log_eps_bar, h_bar, mu = state
        t = torch.as_tensor(t, dtype=torch.float32) + 1.0
        eta = 1.0 / (t + self.t0)
        h_bar = (1.0 - eta) * h_bar + eta * (self.target_accept - accept_prob)
        log_eps = mu - torch.sqrt(t) / self.gamma * h_bar
        w = torch.pow(t, -self.kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        return (log_eps, log_eps_bar, h_bar, mu)


def _per_coord(step_size, q: torch.Tensor):
    """A per-chain step size ``(num_chains,)`` broadcast over ``dim``."""
    if torch.is_tensor(step_size) and step_size.dim() == q.dim() - 1:
        return step_size.unsqueeze(-1)
    return step_size


def _leapfrog(logdensity_and_grad: Callable, q, p, grad, step_size,
              n_steps: int, inv_mass=None):
    """n_steps leapfrog updates. Returns (q, p, logp, grad).

    ``q``, ``p`` and ``grad`` are ``(dim,)`` or ``(num_chains, dim)``;
    ``step_size`` is a number or a per-chain tensor. ``inv_mass`` is an
    optional DIAGONAL inverse mass (a flat vector); ``None`` keeps the unit
    metric. The velocity is ``inv_mass * p``.
    """
    eps = _per_coord(step_size, q)
    logp = None
    for _ in range(n_steps):
        p_half = p + 0.5 * eps * grad
        vel = p_half if inv_mass is None else inv_mass * p_half
        q = q + eps * vel
        logp, grad = logdensity_and_grad(q)
        p = p_half + 0.5 * eps * grad
    return q, p, logp, grad


def hmc_transition(ld_and_grad: Callable, q, logp, grad, step_size,
                   generator: torch.Generator, n_leapfrog: int, *,
                   inv_mass=None, leapfrog_fn: Optional[Callable] = None):
    """One Metropolis-corrected HMC transition for every chain in ``q``.

    Returns ``(q, logp, grad, accept_prob, accepted, diverging)``, each with
    the chain axis first. ``diverging`` is the Stan criterion: the energy
    error exceeds 1000 (or is NaN). ``inv_mass`` (diagonal flat vector or
    None) shapes both the momentum draw (``p ~ N(0, M)``) and the kinetic
    energy. ``leapfrog_fn(q, p, grad, step_size, n_steps)`` swaps in a
    fused integrator (which must already close over the same
    ``inv_mass``); ``None`` runs :func:`_leapfrog`. The MH correction is
    the same either way. Draws: one normal ``q.shape`` momentum, then one
    uniform per chain, both from ``generator``.
    """
    noise = torch.randn(q.shape, generator=generator, dtype=q.dtype,
                        device=q.device)
    p0 = noise if inv_mass is None else noise / torch.sqrt(inv_mass)
    if leapfrog_fn is None:
        q_new, p_new, logp_new, grad_new = _leapfrog(
            ld_and_grad, q, p0, grad, step_size, n_leapfrog,
            inv_mass=inv_mass)
    else:
        q_new, p_new, logp_new, grad_new = leapfrog_fn(
            q, p0, grad, step_size, n_leapfrog)

    def kinetic(p):
        if inv_mass is None:
            return 0.5 * torch.sum(p * p, dim=-1)
        return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

    h0 = -logp + kinetic(p0)
    h1 = -logp_new + kinetic(p_new)
    delta = h0 - h1
    diverging = torch.isnan(delta) | (-delta > 1000.0)
    log_accept = torch.clamp(delta, max=0.0)
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    u = torch.rand(logp.shape, generator=generator, dtype=q.dtype,
                   device=q.device)
    accept = torch.log(u) < log_accept
    q = torch.where(accept.unsqueeze(-1), q_new, q)
    logp = torch.where(accept, logp_new, logp)
    grad = torch.where(accept.unsqueeze(-1), grad_new, grad)
    return q, logp, grad, torch.exp(log_accept), accept, diverging


def make_chain_fn(logdensity: Callable, num_samples: int, step_size: float,
                  n_leapfrog: int, collect: bool = True) -> Callable:
    """Build ``f(generator, q0) -> (qs, logps, accept_probs)`` for a RAW flat
    log-density, so the typed-DSL path and a hand-written density run the
    exact same HMC program. ``q0`` is ``(dim,)`` or ``(num_chains, dim)``;
    the draws axis is inserted after the chain axis. With
    ``collect=False`` it returns ``(q_final, logps, accept_probs)``.

    Each transition is one program (``repro`` jits the chain): on CUDA a
    captured graph, replayed once a draw, as ``run_chains`` runs its
    transitions (``TransitionPrograms``), with no cache key."""
    ld_and_grad = value_and_grad(logdensity)

    def init(q0):
        logp, grad = ld_and_grad(q0)
        return (q0, logp, grad)

    def step(state, generator):
        q, logp, grad = state
        q, logp, grad, acc, _, _ = hmc_transition(
            ld_and_grad, q, logp, grad, step_size, generator, n_leapfrog)
        out = {"logp": logp, "accept_prob": acc}
        if collect:
            out["q"] = q
        return (q, logp, grad), out

    progs = TransitionPrograms(
        TransitionKernel(init, None, lambda s: s, step),
        ProgramKey(("chain_fn",), "chain_fn", None, (), "", ()))

    def chain(generator, q0):
        (q, _, _), draws = progs.run(q0, generator, num_warmup=0,
                                     num_samples=num_samples)
        stats = (draws["logp"].clone(), draws["accept_prob"].clone())
        return ((draws["q"].clone(),) if collect else (q.clone(),)) + stats

    chain.programs = progs
    return chain


@dataclasses.dataclass
class HMC:
    """Static HMC with a fixed number of leapfrog steps (paper setup).

    ``leapfrog``: ``"auto"`` runs the fused n-step integrator when the
    model compiles to a (conditionally) separable spec and the autodiff
    integrator otherwise; ``"fused"`` requires the spec; ``"reference"``
    always runs autodiff. ``inv_mass`` is an optional DIAGONAL inverse
    mass (flat vector over the unconstrained state).
    """

    step_size: float = 0.1
    n_leapfrog: int = 4
    adapt_step_size: bool = False
    target_accept: float = 0.8
    backend: str = "fused"  # log-density backend (see make_logdensity_fn)
    leapfrog: str = "auto"  # "auto" | "fused" | "reference"
    inv_mass: Optional[Any] = None  # diagonal inverse mass (flat vector)

    @property
    def uses_potential_spec(self) -> bool:
        """Whether callers should try to compile a (conditionally)
        separable spec for this sampler (``run_chains`` checks this before
        ``make_kernel``)."""
        return self.leapfrog != "reference"

    def run(self, seed: int, m: Model, num_samples: int,
            num_warmup: int = 0,
            init_varinfo: Optional[TypedVarInfo] = None,
            ctx: Optional[Context] = None,
            num_chains: int = 1, device=None) -> Chain:
        """Sample ``num_chains`` chains of ``m`` on ``device`` (``None``
        means CUDA) through :func:`run_chains`. With several chains, each
        starts from a Uniform(-1, 1) jitter around the discovery draw in
        unconstrained space."""
        return run_chains(seed, m, self, num_samples, num_warmup=num_warmup,
                          num_chains=num_chains, init_varinfo=init_varinfo,
                          init_jitter=1.0 if num_chains > 1 else 0.0,
                          backend=self.backend, ctx=ctx, device=device)

    def _package(self, m: Model, tvi_linked: TypedVarInfo, qs, logps, accs,
                 divs=None) -> Chain:
        """Map flat unconstrained draws back to constrained named arrays."""
        stats = {"logp": logps, "accept_prob": accs}
        if divs is not None:
            stats["diverging"] = divs
        return package_draws(tvi_linked, qs, stats=stats)

    def make_kernel(self, logdensity: Callable, dim: int,
                    spec: Optional[Union[PotentialSpec,
                                         CondPotentialSpec]] = None,
                    spec_reason: Optional[str] = None) -> TransitionKernel:
        """Build the HMC :class:`TransitionKernel` for ``run_chains``.

        Parameters
        ----------
        logdensity : callable
            Flat unconstrained log-density ``(dim,) -> scalar`` (usually
            ``Model.make_logdensity_fn`` output — the fused hot path).
        dim : int
            Length of the flat unconstrained state.
        spec : PotentialSpec or CondPotentialSpec, optional
            Compiled (conditionally) separable potential
            (``repro_torch.core.potential``). When given (and ``leapfrog
            != "reference"``) the kernel runs the fused integrator: chain
            init through ``potential_value_and_grad`` and each
            transition's whole n-step leapfrog through ``fused_leapfrog``,
            one launch for all chains on a separable spec, plain torch on
            a conditional one.
        spec_reason : str, optional
            Compiler diagnosis when ``spec`` is ``None`` — carried on the
            returned kernel (``TransitionKernel.spec_reason``) and quoted
            by the ``leapfrog="fused"`` error.

        Returns
        -------
        TransitionKernel
            State ``(q, logp, grad, da_state, eps)`` with the chain axis
            first; ``step`` emits ``{"q", "logp", "accept_prob",
            "diverging"}`` per draw. Warmup runs dual-averaging adaptation
            when ``adapt_step_size``.
        """
        del dim  # the state shape is carried by q itself
        if self.leapfrog not in ("auto", "fused", "reference"):
            raise ValueError(f"unknown leapfrog mode {self.leapfrog!r}")
        if self.leapfrog == "fused" and spec is None:
            why = f": {spec_reason}" if spec_reason else \
                " (PotentialSpec compilation failed or was not attempted)"
            raise ValueError(
                "leapfrog='fused' requires a (conditionally-)separable "
                f"model{why}; use "
                "leapfrog='auto' to fall back to the autodiff integrator")
        use_fused = spec is not None and self.leapfrog != "reference"
        inv_mass_on = {}  # device -> inv_mass tensor, moved there once

        def inv_mass(q):
            if self.inv_mass is None:
                return None
            if q.device not in inv_mass_on:
                inv_mass_on[q.device] = torch.as_tensor(
                    self.inv_mass, dtype=q.dtype, device=q.device)
            return inv_mass_on[q.device]

        if use_fused:
            def ld_and_grad(q):
                return potential_value_and_grad(spec, q)

            def leapfrog_fn(q, p, grad, eps, n):
                return fused_leapfrog(spec, q, p, grad, eps, n,
                                      inv_mass=inv_mass(q))
        else:
            ld_and_grad = value_and_grad(logdensity)
            leapfrog_fn = None

        da = DualAveraging(target_accept=self.target_accept)

        def init(q0):
            logp0, grad0 = ld_and_grad(q0)
            eps = torch.full(logp0.shape, float(self.step_size),
                             device=q0.device)
            return (q0, logp0, grad0, da.init(eps), eps)

        def warm(state, t, generator):
            q, logp, grad, da_state, eps = state
            cur = torch.exp(da_state[0]) if self.adapt_step_size else eps
            q, logp, grad, acc, _, _ = hmc_transition(
                ld_and_grad, q, logp, grad, cur, generator, self.n_leapfrog,
                inv_mass=inv_mass(q), leapfrog_fn=leapfrog_fn)
            if self.adapt_step_size:
                da_state = da.update(da_state, acc, t)
            return (q, logp, grad, da_state, eps)

        def finalize(state):
            q, logp, grad, da_state, eps = state
            if self.adapt_step_size:
                eps = torch.exp(da_state[1])
            return (q, logp, grad, da_state, eps)

        def step(state, generator):
            q, logp, grad, da_state, eps = state
            q, logp, grad, acc, _, div = hmc_transition(
                ld_and_grad, q, logp, grad, eps, generator, self.n_leapfrog,
                inv_mass=inv_mass(q), leapfrog_fn=leapfrog_fn)
            out = {"q": q, "logp": logp, "accept_prob": acc,
                   "diverging": div}
            return (q, logp, grad, da_state, eps), out

        return TransitionKernel(init, warm, finalize, step,
                                spec_reason=None if use_fused
                                else spec_reason)

    # -- untyped eager path (the paper's slow general mode) -------------------
    def run_untyped(self, seed: int, m: Model, num_samples: int,
                    init_varinfo: Optional[TypedVarInfo] = None,
                    device=None) -> Chain:
        """Same algorithm, executed through the untyped eager path.

        One chain. Every log-density and gradient replays the model eagerly
        through the per-site evaluator (``eager=True``: a ``reject()``
        aborts the replay) with ``torch.autograd`` for the gradient, on
        ``device`` (``None`` means CUDA), and the loop, the momentum and the
        accept draws are NumPy's (``np.random.default_rng(seed)``; the
        discovery draw, when ``init_varinfo`` is absent, comes from a
        ``torch.Generator`` seeded with ``seed``). ``step_size`` and
        ``n_leapfrog`` as in :meth:`run`; the unit metric, no adaptation.
        """
        dev = resolve_device(device)
        tvi = (init_varinfo if init_varinfo is not None
               else m.typed_varinfo(
                   torch.Generator(device=dev).manual_seed(int(seed))))
        assert_continuous_supports(tvi, "HMC")
        tvi = tvi.link()
        ctx = DefaultContext()

        def logp_and_grad(q: np.ndarray):
            # fresh eager evaluation each call: the dynamic path
            u = torch.as_tensor(q, device=dev).requires_grad_(True)
            lp = m._eval_logp(tvi.replace_flat(u), ctx, eager=True)
            if torch.is_tensor(lp) and lp.requires_grad:
                (g,) = torch.autograd.grad(lp, u)
                g = g.detach().cpu().numpy()
            else:  # rejected replay: a constant -inf
                g = np.zeros_like(q)
            return float(lp.detach()), g

        rng = np.random.default_rng(int(seed))
        q = tvi.flat().detach().cpu().numpy()
        logp, grad = logp_and_grad(q)
        eps = self.step_size
        qs, logps, accs = [], [], []
        for _ in range(num_samples):
            p0 = rng.standard_normal(q.shape).astype(q.dtype)
            qn, pn, gn = q.copy(), p0.copy(), grad.copy()
            for _ in range(self.n_leapfrog):
                pn = pn + 0.5 * eps * gn
                qn = qn + eps * pn
                lpn, gn = logp_and_grad(qn)
                pn = pn + 0.5 * eps * gn
            h0 = -logp + 0.5 * float(p0 @ p0)
            h1 = -lpn + 0.5 * float(pn @ pn)
            # a NaN energy error rejects, as in hmc_transition (Python's
            # min(0.0, nan) would return 0.0 and accept)
            log_acc = -np.inf if np.isnan(h0 - h1) else min(0.0, h0 - h1)
            if np.log(rng.uniform()) < log_acc:
                q, logp, grad = qn, lpn, gn
            qs.append(q.copy())
            logps.append(logp)
            accs.append(np.exp(log_acc))

        qs = torch.as_tensor(np.stack(qs), device=dev)[None]
        return self._package(m, tvi, qs, np.asarray(logps)[None],
                             np.asarray(accs)[None])
