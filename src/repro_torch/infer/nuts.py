"""NUTS — iterative No-U-Turn sampler (multinomial variant), all chains in
lockstep.

The checkpoint-stack iterative formulation of ``repro.infer.nuts``: a
doubling tree of depth up to ``max_depth``; u-turn checks against
power-of-two subtree boundaries use a checkpoint array indexed by the
binary structure of the leaf counter (:func:`_leaf_to_ckpt`).

``repro`` runs the tree as three nested ``lax.while_loop`` s under
``vmap`` over chains, and ``vmap`` turns each batched predicate into
"loop while any chain is live, and freeze the chains that are done".
The port does the same by hand on ``(num_chains, dim)`` tensors: every
carried field is updated through ``torch.where`` on a per-chain mask, and
each loop continues while any chain is live. Each continuation test is a
host sync (``Tensor.any()`` read on the host); :data:`TREE_COUNTS` counts
them with the lockstep leaf iterations. A frozen chain's row is still
evaluated and its result discarded, as under ``vmap``, so each lockstep
leaf iteration is ONE evaluation for all chains: one
``fused_potential_vg`` launch on a separable spec, the plain-torch
conditional evaluator on a conditional one, else one autodiff
``value_and_grad`` of the fused log-joint (one ``fused_logpdf`` launch
per density family). The work between two loop tests (a transition's
start, a doubling's start and merge, a leaf iteration) is a
``CompiledProgram`` over the tree's buffers, so on the card each is one
CUDA graph replay and the host does only the loop tests; a graph of a
whole doubling, with the tests on the device, is ROADMAP Queue 1 item
11c.

Randomness: every draw comes from the run's one ``torch.Generator``, for
all chains at once (frozen ones included), in this order per transition:
the momentum ``randn (num_chains, dim)``; then for each doubling, one
direction uniform ``(num_chains,)``, one uniform ``(num_chains,)`` per
lockstep leaf iteration (the progressive-sampling draw), and one merge
uniform ``(num_chains,)``. On a chains mesh each rank draws the fleet's
and keeps its rows, and each loop test is the fleet's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.model import Model
from repro_torch.core.program import CompiledProgram, ProgramKey
from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.infer.chains import (Chain, TransitionKernel, chain_draw,
                                      run_chains)
from repro_torch.infer.hmc import DualAveraging, value_and_grad
from repro_torch.kernels.fused_leapfrog.ops import potential_value_and_grad
from repro_torch.sharding.mesh import active_run

__all__ = ["NUTS", "TREE_COUNTS", "reset_tree_counts"]

# since the last reset: NUTS transitions (trees), lockstep leaf iterations
# (each one density evaluation for all chains) and host syncs (loop tests
# read on the host), over all transitions and over the kernel's sampling
# draws (``step``, not ``warm``); and the leaf iterations of the last
# transition
TREE_COUNTS = {"trees": 0, "leaf_iterations": 0, "host_syncs": 0,
               "draws": 0, "draw_leaf_iterations": 0, "draw_host_syncs": 0,
               "last_leaf_iterations": 0}


def reset_tree_counts() -> None:
    for k in TREE_COUNTS:
        TREE_COUNTS[k] = 0


def _is_turning(q_l, p_l, q_r, p_r):
    """The u-turn criterion on the last axis: ``(dim,)`` states or a chain
    batch ``(num_chains, dim)``."""
    dq = q_r - q_l
    return (torch.sum(dq * p_l, dim=-1) <= 0.0) | \
        (torch.sum(dq * p_r, dim=-1) <= 0.0)


def _leaf_to_ckpt(n: int, max_depth: int):
    """leaf counter -> (idx_min, idx_max) of checkpoints to u-turn-check.

    ``idx_max`` is the number of set bits of ``n >> 1`` and ``idx_min =
    idx_max - trailing_ones(n) + 1``, as ``repro``'s while loops count
    them; here ``trailing_ones(n) = popcount(n ^ (n + 1)) - 1``. ``n`` is
    a host int: every live chain is at the same leaf of the same level.
    ``max_depth`` is ``repro``'s argument; Python ints need no bit width.
    """
    del max_depth
    idx_max = (n >> 1).bit_count()
    return idx_max - ((n ^ (n + 1)).bit_count() - 1) + 1, idx_max


def _sync_any(mask: torch.Tensor) -> bool:
    """A loop test read on the host: one sync, counted. On a chains mesh
    the test is the fleet's (one flag reduction along the chain axis), so
    every rank loops as the unsharded run does."""
    TREE_COUNTS["host_syncs"] += 1
    flag = bool(mask.any())
    run = active_run()
    if run is not None and run.num_chain_devices > 1:
        flag = run.any_chains(flag)
    return flag


def _keep(live, new, old):
    """``new`` on the live chains, ``old`` on the frozen ones."""
    m = live if new.dim() == 1 else live.view((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


@dataclasses.dataclass
class NUTS:
    step_size: float = 0.1
    max_depth: int = 10
    adapt_step_size: bool = True
    target_accept: float = 0.8
    backend: str = "fused"  # log-density backend (see make_logdensity_fn)
    leapfrog: str = "auto"  # "auto" | "fused" | "reference"

    @property
    def uses_potential_spec(self) -> bool:
        """Whether callers should try to compile a (conditionally)
        separable spec for this sampler (``run_chains`` checks this before
        ``make_kernel``)."""
        return self.leapfrog != "reference"

    def _make_ld_grad(self, logdensity, spec, spec_reason=None):
        """(logp, grad) evaluator for tree leaves, on ``(num_chains, dim)``.

        With a compiled PotentialSpec the gradient is the analytic opcode
        table (one ``fused_potential_vg`` launch for all chains, zero
        autodiff); with a CondPotentialSpec the analytic leaves and the
        head's autodiff in plain torch under ``vmap``; otherwise the
        autodiff ``value_and_grad`` of the log-density under ``vmap``.
        """
        if self.leapfrog not in ("auto", "fused", "reference"):
            raise ValueError(f"unknown leapfrog mode {self.leapfrog!r}")
        if self.leapfrog == "fused" and spec is None:
            why = f": {spec_reason}" if spec_reason else \
                " (PotentialSpec compilation failed or was not attempted)"
            raise ValueError(
                "leapfrog='fused' requires a (conditionally-)separable "
                f"model{why}; use leapfrog='auto' to fall back to autodiff "
                "gradients")
        if spec is not None and self.leapfrog != "reference":
            return lambda q: potential_value_and_grad(spec, q)
        return value_and_grad(logdensity)

    def _build_step(self, ld_grad, dim: int):
        """Build the NUTS transition for all chains in lockstep.

        Returns ``nuts_step(q0, logp0, grad0, eps, generator) -> (q, logp,
        grad, accept_prob, tree_depth, diverging)``, each with the chain
        axis first (``q0 (num_chains, dim)``; ``eps`` a number or a
        per-chain tensor); shared by :meth:`run` and :meth:`make_kernel`.

        The tree's state lives in buffers kept per ``(num_chains, dim)``,
        and the work between two loop tests is a program that updates them
        in place: the transition's start, each doubling's start and merge,
        and each leaf iteration, one program a (parity, ``idx_min``,
        ``idx_max``) of its checkpoint slots (O(max_depth^2) of them, each
        captured at its second use). On CUDA each is a graph replay, and
        the host reads one loop test between two of them.
        """
        del dim  # carried by q0
        max_depth = int(self.max_depth)
        k_slots = max_depth + 1
        trees = {}  # (shape, dtype, device) -> the tree's buffers

        def buffers(q0):
            key = (tuple(q0.shape), q0.dtype, q0.device)
            b = trees.get(key)
            if b is None:
                n, dt, dev = q0.shape[0], q0.dtype, q0.device

                def new(shape=(n,), dtype=dt):
                    return torch.zeros(shape, dtype=dtype, device=dev)

                vec, col, flag = tuple(q0.shape), (n, 1), torch.bool
                b = trees[key] = dict(
                    # the transition
                    h0=new(), e_abs=new(col),
                    # the tree (repro's `state`)
                    q_l=new(vec), p_l=new(vec), g_l=new(vec), q_r=new(vec),
                    p_r=new(vec), g_r=new(vec), q_prop=new(vec),
                    logp_prop=new(), g_prop=new(vec), log_weight=new(),
                    depth=new(dtype=torch.int64), turning=new(dtype=flag),
                    diverging=new(dtype=flag), sum_acc=new(), n_acc=new(),
                    active=new(dtype=flag),
                    # the doubling (repro's `sub`)
                    right=new(col, flag), direction=new(col), e=new(col),
                    q=new(vec), p=new(vec), g=new(vec),
                    ck_q=new((n, k_slots) + vec[1:]),
                    ck_p=new((n, k_slots) + vec[1:]), sub_log_w=new(),
                    sub_turn=new(dtype=flag), sub_div=new(dtype=flag),
                    sq_prop=new(vec), slogp_prop=new(), sg_prop=new(vec),
                    sub_sum_acc=new(), sub_n_acc=new(), live=new(dtype=flag))
            return b

        def uniform(b, generator):
            return chain_draw(torch.rand, b["h0"].shape, generator=generator,
                              dtype=b["h0"].dtype, device=b["h0"].device)

        def start(b, q0, logp0, grad0, eps, generator):
            p0 = chain_draw(torch.randn, q0.shape, generator=generator,
                            dtype=q0.dtype, device=q0.device)
            b["h0"].copy_(-logp0 + 0.5 * torch.sum(p0 * p0, dim=-1))
            b["e_abs"].copy_(eps.reshape(-1, 1) if eps.dim() else eps)
            for side in ("l", "r"):
                b["q_" + side].copy_(q0)
                b["p_" + side].copy_(p0)
                b["g_" + side].copy_(grad0)
            b["q_prop"].copy_(q0)
            b["logp_prop"].copy_(logp0)
            b["g_prop"].copy_(grad0)
            for k in ("log_weight", "depth", "turning", "diverging",
                      "sum_acc", "n_acc"):
                b[k].zero_()
            b["active"].copy_(~b["turning"] & ~b["diverging"])

        def begin(b, generator):
            go_right = uniform(b, generator) < 0.5
            right = go_right.unsqueeze(-1)
            direction = torch.where(right, 1.0, -1.0).to(b["e"].dtype)
            b["right"].copy_(right)
            b["direction"].copy_(direction)
            b["e"].copy_(b["e_abs"] * direction)
            for k in ("q", "p", "g"):
                b[k].copy_(torch.where(right, b[k + "_r"], b[k + "_l"]))
            b["ck_q"].zero_()
            b["ck_p"].zero_()
            b["sub_log_w"].fill_(-torch.inf)
            b["sub_turn"].zero_()
            b["sub_div"].zero_()
            b["sq_prop"].copy_(b["q"])
            b["slogp_prop"].zero_()
            b["sg_prop"].copy_(b["g"])
            b["sub_sum_acc"].copy_(b["sum_acc"])
            b["sub_n_acc"].copy_(b["n_acc"])
            b["live"].copy_(b["active"])

        def leaf_body(b, generator, parity, idx_min, idx_max):
            q, p, g, e, h0 = b["q"], b["p"], b["g"], b["e"], b["h0"]
            live, sub_turn = b["live"], b["sub_turn"]
            p_h = p + 0.5 * e * g
            q_n = q + e * p_h
            logp_n, g_n = ld_grad(q_n)
            p_n = p_h + 0.5 * e * g_n
            h = -logp_n + 0.5 * torch.sum(p_n * p_n, dim=-1)
            div_n = b["sub_div"] | (h - h0 > 1000.0) | torch.isnan(h)
            lw = torch.where(div_n, -torch.inf, h0 - h)
            # multinomial progressive sampling within the subtree
            total_n = torch.logaddexp(b["sub_log_w"], lw)
            take = torch.log(uniform(b, generator)) < lw - total_n
            acc_n = b["sub_sum_acc"] + torch.clamp(torch.exp(h0 - h),
                                                   max=1.0)
            # u-turn checks via the checkpoint stack: every live chain is
            # at this leaf, so the slots are host ints; a frozen chain's
            # slots are written too, and its checks dropped by _keep
            if parity == 0:
                b["ck_q"][:, idx_max] = q_n
                b["ck_p"][:, idx_max] = p_n
                new_turn = sub_turn
            else:
                ckq = b["ck_q"][:, idx_min:idx_max + 1]
                dq = b["direction"].unsqueeze(1) * (q_n.unsqueeze(1) - ckq)
                turns = (
                    (torch.sum(dq * b["ck_p"][:, idx_min:idx_max + 1],
                               dim=-1) <= 0.0)
                    | (torch.sum(dq * p_n.unsqueeze(1), dim=-1) <= 0.0))
                new_turn = _keep(live, sub_turn | turns.any(-1), sub_turn)
            # commit on the live chains only
            took = live & take
            new = dict(
                q=_keep(live, q_n, q), p=_keep(live, p_n, p),
                g=_keep(live, g_n, g),
                sub_log_w=_keep(live, total_n, b["sub_log_w"]),
                sub_div=_keep(live, div_n, b["sub_div"]),
                sq_prop=_keep(took, q_n, b["sq_prop"]),
                slogp_prop=_keep(took, logp_n, b["slogp_prop"]),
                sg_prop=_keep(took, g_n, b["sg_prop"]),
                sub_sum_acc=_keep(live, acc_n, b["sub_sum_acc"]),
                sub_n_acc=_keep(live, b["sub_n_acc"] + 1.0,
                                b["sub_n_acc"]),
                sub_turn=new_turn)
            new["live"] = live & ~new_turn & ~new["sub_div"]
            for k, v in new.items():
                b[k].copy_(v)

        def merge(b, generator):
            # merge the subtree's proposal with the main one (biased
            # progressive sampling toward the new subtree)
            right, active = b["right"], b["active"]
            sub_turn, sub_div = b["sub_turn"], b["sub_div"]
            take_new = ((torch.log(uniform(b, generator)) < b["sub_log_w"]
                         - b["log_weight"]) & ~sub_turn & ~sub_div)
            new = dict(
                q_prop=_keep(take_new, b["sq_prop"], b["q_prop"]),
                logp_prop=_keep(take_new, b["slogp_prop"], b["logp_prop"]),
                g_prop=_keep(take_new, b["sg_prop"], b["g_prop"]),
                log_weight=torch.logaddexp(b["log_weight"], b["sub_log_w"]),
                q_l=torch.where(right, b["q_l"], b["q"]),
                p_l=torch.where(right, b["p_l"], b["p"]),
                g_l=torch.where(right, b["g_l"], b["g"]),
                q_r=torch.where(right, b["q"], b["q_r"]),
                p_r=torch.where(right, b["p"], b["p_r"]),
                g_r=torch.where(right, b["g"], b["g_r"]),
                depth=b["depth"] + 1,
                diverging=b["diverging"] | sub_div,
                sum_acc=b["sub_sum_acc"], n_acc=b["sub_n_acc"])
            new["turning"] = sub_turn | _is_turning(
                new["q_l"], new["p_l"], new["q_r"], new["p_r"])
            new = {k: _keep(active, v, b[k]) for k, v in new.items()}
            for k, v in new.items():
                b[k].copy_(v)
            b["active"].copy_(~b["turning"] & ~b["diverging"])

        key = ProgramKey(("nuts",), "nuts_tree", None, (), self.backend,
                         (max_depth,))
        programs = {
            name: CompiledProgram(key._replace(kind=f"nuts_{name}"), fn,
                                  donate_argnums=(0,), static_argnums=static)
            for name, fn, static in (("start", start, ()),
                                     ("begin", begin, ()),
                                     ("leaf", leaf_body, (2, 3, 4)),
                                     ("merge", merge, ()))}

        def nuts_step(q0, logp0, grad0, eps, generator):
            b = buffers(q0)
            if not torch.is_tensor(eps):
                eps = torch.full(q0.shape[:1], float(eps), dtype=q0.dtype,
                                 device=q0.device)
            programs["start"](b, q0, logp0, grad0, eps, generator)
            leaves = 0
            # every live chain has grown the same number of doublings, so
            # the level (and its subtree size 2^level) is one host int
            for level in range(max_depth):
                if not _sync_any(b["active"]):
                    break
                programs["begin"](b, generator)
                for leaf in range(1 << level):
                    if leaf > 0 and not _sync_any(b["live"]):
                        break
                    leaves += 1
                    idx_min, idx_max = _leaf_to_ckpt(leaf, max_depth)
                    programs["leaf"](b, generator, leaf % 2, idx_min,
                                     idx_max)
                programs["merge"](b, generator)
            TREE_COUNTS["trees"] += 1
            TREE_COUNTS["leaf_iterations"] += leaves
            TREE_COUNTS["last_leaf_iterations"] = leaves
            acc_prob = b["sum_acc"] / torch.clamp(b["n_acc"], min=1.0)
            return (b["q_prop"].clone(), b["logp_prop"].clone(),
                    b["g_prop"].clone(), acc_prob, b["depth"].clone(),
                    b["diverging"].clone())

        nuts_step.programs = tuple(programs.values())
        return nuts_step

    # -- TransitionKernel protocol (run_chains driver) -------------------------
    def make_kernel(self, logdensity, dim: int, spec=None,
                    spec_reason: Optional[str] = None) -> TransitionKernel:
        """Build the NUTS :class:`TransitionKernel` for ``run_chains``.

        State is ``(q, logp, grad, da_state, eps)`` with the chain axis
        first; ``step`` emits ``{"q", "logp", "accept_prob", "tree_depth",
        "diverging"}`` per draw (``diverging``: the doubling tree hit an
        energy error > 1000 or NaN and was truncated). Warmup runs
        dual-averaging on the mean subtree acceptance statistic, per chain.
        ``spec`` (an optional compiled PotentialSpec or CondPotentialSpec)
        swaps the tree-leaf gradient for the fused analytic evaluator;
        ``spec_reason`` (the compiler diagnosis when ``spec`` is None)
        rides on the returned kernel so the fallback is explainable.
        """
        ld_grad = self._make_ld_grad(logdensity, spec, spec_reason)
        nuts_step = self._build_step(ld_grad, dim)
        da = DualAveraging(target_accept=self.target_accept)

        def init(q0):
            logp0, grad0 = ld_grad(q0)
            eps = torch.full(logp0.shape, float(self.step_size),
                             device=q0.device)
            return (q0, logp0, grad0, da.init(eps), eps)

        def warm(state, t, generator):
            q, logp, grad, da_state, eps = state
            cur = torch.exp(da_state[0]) if self.adapt_step_size else eps
            q, logp, grad, acc, _, _ = nuts_step(q, logp, grad, cur,
                                                 generator)
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
            before = (TREE_COUNTS["leaf_iterations"],
                      TREE_COUNTS["host_syncs"])
            q, logp, grad, acc, depth, div = nuts_step(q, logp, grad, eps,
                                                       generator)
            TREE_COUNTS["draws"] += 1
            TREE_COUNTS["draw_leaf_iterations"] += \
                TREE_COUNTS["leaf_iterations"] - before[0]
            TREE_COUNTS["draw_host_syncs"] += \
                TREE_COUNTS["host_syncs"] - before[1]
            out = {"q": q, "logp": logp, "accept_prob": acc,
                   "tree_depth": depth, "diverging": div}
            return (q, logp, grad, da_state, eps), out

        use_fused = spec is not None and self.leapfrog != "reference"
        # the loop tests are read on the host: the leaf iterations are the
        # captured programs (_build_step), the transition runs around them
        return TransitionKernel(init, warm, finalize, step,
                                spec_reason=None if use_fused
                                else spec_reason, capturable=False,
                                programs=nuts_step.programs)

    def run(self, seed: int, m: Model, num_samples: int,
            num_warmup: int = 500,
            init_varinfo: Optional[TypedVarInfo] = None,
            num_chains: int = 1, device=None) -> Chain:
        """Sample ``num_chains`` chains of ``m`` on ``device`` (``None``
        means CUDA) through :func:`run_chains`, every chain from the
        discovery draw; ``chain.stats["tree_depth"]`` holds the depths."""
        return run_chains(seed, m, self, num_samples, num_warmup=num_warmup,
                          num_chains=num_chains, init_varinfo=init_varinfo,
                          init_jitter=0.0, backend=self.backend,
                          device=device)
