#!/usr/bin/env python3
"""The lockstep NUTS leaf loop in two designs, on the card, in one process.

    python3 probes/nuts_leaf_loop.py

``repro_torch.infer.nuts`` keeps every live chain at one leaf of one
level, so it finds the checkpoint slots of a leaf from the host's loop
index, writes one slot in place on even leaves and checks only the
slot range on odd ones. Its first design (kept here as
``per_chain_counter_step``) carried a per-chain int64 leaf counter,
computed the slots by popcounts on it, and wrote and checked every
slot under masks. Both run gaussian_10k's fused leaves through
``run_chains`` (4 chains, 40 warmup and 60 draws, the same seed), in
turns first, second, second, first; the draws must be bit-identical.
The card's name and power limit come first; the last line is one JSON
object: seconds, leaf iterations, host syncs and ms a leaf iteration of
each run.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.infer import nuts as nuts_mod  # noqa: E402
from repro_torch.infer.chains import run_chains  # noqa: E402
from repro_torch.infer.hmc import _per_coord  # noqa: E402
from repro_torch.infer.nuts import (NUTS, TREE_COUNTS, _is_turning,  # noqa: E402
                                    _keep, _sync_any)


def _popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    shifts = torch.arange(bits, device=x.device, dtype=x.dtype)
    return ((x.unsqueeze(-1) >> shifts) & 1).sum(-1)


def _leaf_to_ckpt_per_chain(n: torch.Tensor, max_depth: int):
    n = n.to(torch.int64)
    idx_max = _popcount(n >> 1, max_depth + 1)
    return idx_max - (_popcount(n ^ (n + 1), max_depth + 1) - 1) + 1, idx_max


def per_chain_counter_step(self, ld_grad, dim: int):
    """``NUTS._build_step`` with the leaf loop of its first design: a
    per-chain int64 leaf counter, its checkpoint slots found by popcounts
    and written and checked through masks over all ``max_depth + 1``
    slots on every leaf."""
    del dim  # carried by q0
    max_depth = int(self.max_depth)
    k_slots = max_depth + 1

    def nuts_step(q0, logp0, grad0, eps, generator):
        n_chains = q0.shape[0]
        dev, dt = q0.device, q0.dtype
        e_abs = _per_coord(eps, q0)
        slots = torch.arange(k_slots, device=dev)

        def uniform():
            return torch.rand((n_chains,), generator=generator,
                              dtype=dt, device=dev)

        p0 = torch.randn(q0.shape, generator=generator, dtype=dt,
                         device=dev)
        h0 = -logp0 + 0.5 * torch.sum(p0 * p0, dim=-1)
        false = torch.zeros((n_chains,), dtype=torch.bool, device=dev)
        zero = torch.zeros((n_chains,), dtype=dt, device=dev)
        s = dict(q_l=q0, p_l=p0, g_l=grad0, q_r=q0, p_r=p0, g_r=grad0,
                 q_prop=q0, logp_prop=logp0, g_prop=grad0,
                 log_weight=zero, depth=torch.zeros(
                     (n_chains,), dtype=torch.int64, device=dev),
                 turning=false, diverging=false, sum_acc=zero,
                 n_acc=zero)
        leaves = 0
        # every live chain has grown the same number of doublings, so
        # the level (and its subtree size 2^level) is one host int
        for level in range(max_depth):
            active = ~s["turning"] & ~s["diverging"]
            if not _sync_any(active):
                break
            go_right = uniform() < 0.5
            right = go_right.unsqueeze(-1)
            direction = torch.where(right, 1.0, -1.0).to(dt)
            e = e_abs * direction
            q = torch.where(right, s["q_r"], s["q_l"])
            p = torch.where(right, s["p_r"], s["p_l"])
            g = torch.where(right, s["g_r"], s["g_l"])
            # the subtree's carry (repro's `sub`)
            ck_q = torch.zeros((n_chains, k_slots) + q0.shape[1:],
                               dtype=dt, device=dev)
            ck_p = torch.zeros_like(ck_q)
            sub_log_w = torch.full((n_chains,), -torch.inf, dtype=dt,
                                   device=dev)
            sub_turn, sub_div = false, false
            sq_prop, slogp_prop, sg_prop = q, zero, g
            sum_acc, n_acc = s["sum_acc"], s["n_acc"]
            i = torch.zeros((n_chains,), dtype=torch.int64, device=dev)
            live = active
            n_leaf = 1 << level
            for leaf in range(n_leaf):
                if leaf > 0 and not _sync_any(live):
                    break
                leaves += 1
                p_h = p + 0.5 * e * g
                q_n = q + e * p_h
                logp_n, g_n = ld_grad(q_n)
                p_n = p_h + 0.5 * e * g_n
                h = -logp_n + 0.5 * torch.sum(p_n * p_n, dim=-1)
                div_n = sub_div | (h - h0 > 1000.0) | torch.isnan(h)
                lw = torch.where(div_n, -torch.inf, h0 - h)
                # multinomial progressive sampling within the subtree
                total_n = torch.logaddexp(sub_log_w, lw)
                take = torch.log(uniform()) < lw - total_n
                acc_n = sum_acc + torch.clamp(torch.exp(h0 - h), max=1.0)
                # u-turn checks via the checkpoint stack
                idx_min, idx_max = _leaf_to_ckpt_per_chain(i, max_depth)
                even = (i & 1) == 0
                write = (even.unsqueeze(-1)
                         & (slots == idx_max.unsqueeze(-1))).unsqueeze(-1)
                ckq_n = torch.where(write, q_n.unsqueeze(1), ck_q)
                ckp_n = torch.where(write, p_n.unsqueeze(1), ck_p)
                dq = direction.unsqueeze(1) * (q_n.unsqueeze(1) - ckq_n)
                rgt = right.unsqueeze(1)
                p_lo = torch.where(rgt, ckp_n, p_n.unsqueeze(1))
                p_hi = torch.where(rgt, p_n.unsqueeze(1), ckp_n)
                turns = ((torch.sum(dq * p_lo, dim=-1) <= 0.0)
                         | (torch.sum(dq * p_hi, dim=-1) <= 0.0))
                checked = ((slots >= idx_min.unsqueeze(-1))
                           & (slots <= idx_max.unsqueeze(-1)))
                turn_n = sub_turn | (~even & (turns & checked).any(-1))
                # commit on the live chains only
                q, p, g = (_keep(live, q_n, q), _keep(live, p_n, p),
                           _keep(live, g_n, g))
                ck_q, ck_p = _keep(live, ckq_n, ck_q), _keep(live, ckp_n,
                                                             ck_p)
                sub_log_w = _keep(live, total_n, sub_log_w)
                sub_turn = _keep(live, turn_n, sub_turn)
                sub_div = _keep(live, div_n, sub_div)
                took = live & take
                sq_prop = _keep(took, q_n, sq_prop)
                slogp_prop = _keep(took, logp_n, slogp_prop)
                sg_prop = _keep(took, g_n, sg_prop)
                sum_acc = _keep(live, acc_n, sum_acc)
                n_acc = _keep(live, n_acc + 1.0, n_acc)
                i = i + live.to(i.dtype)
                live = live & (i < n_leaf) & ~sub_turn & ~sub_div

            # merge the subtree's proposal with the main one (biased
            # progressive sampling toward the new subtree)
            take_new = ((torch.log(uniform()) < sub_log_w
                         - s["log_weight"]) & ~sub_turn & ~sub_div)
            new = dict(
                q_prop=_keep(take_new, sq_prop, s["q_prop"]),
                logp_prop=_keep(take_new, slogp_prop, s["logp_prop"]),
                g_prop=_keep(take_new, sg_prop, s["g_prop"]),
                log_weight=torch.logaddexp(s["log_weight"], sub_log_w),
                q_l=torch.where(right, s["q_l"], q),
                p_l=torch.where(right, s["p_l"], p),
                g_l=torch.where(right, s["g_l"], g),
                q_r=torch.where(right, q, s["q_r"]),
                p_r=torch.where(right, p, s["p_r"]),
                g_r=torch.where(right, g, s["g_r"]),
                depth=s["depth"] + 1,
                diverging=s["diverging"] | sub_div,
                sum_acc=sum_acc, n_acc=n_acc)
            new["turning"] = sub_turn | _is_turning(
                new["q_l"], new["p_l"], new["q_r"], new["p_r"])
            s = {k: _keep(active, new[k], v) if k in new else v
                 for k, v in s.items()}
        TREE_COUNTS["trees"] += 1
        TREE_COUNTS["leaf_iterations"] += leaves
        TREE_COUNTS["last_leaf_iterations"] = leaves
        acc_prob = s["sum_acc"] / torch.clamp(s["n_acc"], min=1.0)
        return (s["q_prop"], s["logp_prop"], s["g_prop"], acc_prob,
                s["depth"], s["diverging"])

    return nuts_step

class PerChainCounterNUTS(NUTS):
    _build_step = per_chain_counter_step


def main() -> int:
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    from repro_torch.kernels.fused_logpdf import ops
    cs.build_all({cs.LOGPDF_CU: ops._lib, cs.LEAPFROG_CU: lf_ops._lib})
    print(cs.nvidia_smi(), flush=True)
    pm = cs.build_model("gaussian_10k")
    runs, draws = [], {}
    for label, cls in (("per_chain_counter", PerChainCounterNUTS),
                       ("host_int_slots", NUTS), ("host_int_slots", NUTS),
                       ("per_chain_counter", PerChainCounterNUTS)):
        nuts_mod.reset_tree_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain = run_chains(0, pm.model, cls(step_size=pm.step_size,
                                            max_depth=10), 60,
                           num_warmup=40, num_chains=4, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        leaves = TREE_COUNTS["leaf_iterations"]
        runs.append({"design": label, "seconds": secs,
                     "leaf_iterations": leaves,
                     "host_syncs": TREE_COUNTS["host_syncs"],
                     "ms_per_leaf_iteration": secs * 1e3 / leaves})
        print(json.dumps(runs[-1]), flush=True)
        draws.setdefault(label, chain["x"])
    same = bool(np.array_equal(draws["per_chain_counter"],
                               draws["host_int_slots"]))
    print(json.dumps({"runs": runs, "draws_bit_identical": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
