"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared
experts, as ``repro.nn.moe``.

Two dispatch implementations, with the JAX package's names and contracts:

* ``moe_ffn`` — each (token, choice) pair gets a position within its
  expert from a cumulative sum over the pairs in token order; a pair past
  its expert's capacity ``cap = ceil(N k / E * capacity_factor)`` is
  dropped. At decode (N = one token a request) the capacity is small and
  most pairs are dropped, as in the JAX package, so prefill plus decode
  differs from ``forward_train`` unless the capacity leaves room
  (``capacity_factor = E / k``).
* ``moe_ffn_ep`` — expert parallelism over the port's mesh of ranks (one
  process a rank, ``repro_torch.sharding``): each rank takes its data
  shard's rows and its ``E / n`` experts, routes and dispatches to its own
  experts with the capacity counted over its shard, and ONE all-reduce
  over the expert axis joins the parts; an all-gather over the batch axes
  then gives every rank the whole output. It falls back to ``moe_ffn`` in
  the JAX package's three cases: no active rules, no ``experts`` axis on
  the mesh, or E not divisible by the axis's ranks.

The dispatch and the combine are deterministic and capture-safe (the
serving decode step is a CUDA graph): no boolean-mask indexing, no
``nonzero``, no host read, no atomics. Every pair is copied
(``index_copy``) into a buffer of E * cap + 1 rows, each kept pair to a
row of its own and every dropped pair to the last row, which no expert
reads. The combine gathers each pair's expert output (a zero row for a
dropped pair), weights it by its gate in the input's type and sums a
token's k pairs in float32, rounded once. The JAX package scatter-adds
the k products in the input's type: the two differ only by bf16 rounding
(ROADMAP Queue 3 B).

Routing runs in float32: the router product has a float32 result
(``f32_product``, cuBLAS's bf16 product with float32 output for bf16
inputs on the card), then softmax, ``torch.topk`` (sorted, descending)
and the top-k renormalisation.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.nn.common import Initializer, f32_product
from repro_torch.sharding.mesh import world_rank

__all__ = ["init_moe_params", "moe_ffn", "moe_ffn_ep", "shared_expert_ffn"]


def init_moe_params(init: Initializer, path: str, d_model: int,
                    d_expert: int, n_experts: int, n_shared: int = 0,
                    d_shared: Optional[int] = None) -> Dict[str, Any]:
    """The router (D, E), the experts' stacked (E, D, F), (E, D, F) and
    (E, F, D) weights and the shared experts' dense ones. ``w_gate`` and
    ``w_up`` take ``Initializer.dense``'s default fan-in, their first dim
    (E), as the JAX package's do: std 1/sqrt(E) (ROADMAP Queue 3 C)."""
    p = {
        "router": init.dense(f"{path}/router", (d_model, n_experts)),
        "experts": {
            "w_gate": init.dense(f"{path}/e_gate",
                                 (n_experts, d_model, d_expert)),
            "w_up": init.dense(f"{path}/e_up", (n_experts, d_model, d_expert)),
            "w_down": init.dense(f"{path}/e_down",
                                 (n_experts, d_expert, d_model),
                                 fan_in=d_expert),
        },
    }
    if n_shared > 0:
        ds = d_shared if d_shared is not None else n_shared * d_expert
        p["shared"] = {
            "w_gate": init.dense(f"{path}/s_gate", (d_model, ds)),
            "w_up": init.dense(f"{path}/s_up", (d_model, ds)),
            "w_down": init.dense(f"{path}/s_down", (ds, d_model), fan_in=ds),
        }
    return p


def _route(xt, router, top_k: int, norm_topk_probs: bool):
    """(gates (N, k) float32, experts (N, k)): the top k of the float32
    softmax over the router's logits, largest first."""
    gates = torch.softmax(f32_product(xt, router.T), dim=-1)
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1)
    if norm_topk_probs:
        top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    return top_vals, top_idx


def _capacity(n_tokens: int, top_k: int, n_experts: int,
              capacity_factor: float) -> int:
    """Pairs an expert takes: a Python int from static shapes."""
    return int(math.ceil(n_tokens * top_k / n_experts * capacity_factor))


def _positions(local_e, mine, n_experts: int):
    """Each pair's position among the pairs ``mine`` routes to its expert
    ``local_e``, in pair order (a cumulative sum of one-hot rows)."""
    onehot = ((local_e[:, None] == torch.arange(
        n_experts, device=local_e.device)) & mine[:, None]).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    return torch.sum(pos_all * onehot, dim=-1)


def _experts(xe, ew, dtype):
    """The experts' SwiGLU over (e, cap, D) buffers, batched."""
    g = torch.bmm(xe, ew["w_gate"])
    u = torch.bmm(xe, ew["w_up"])
    h = F.silu(g.float()).to(dtype) * u
    return torch.bmm(h, ew["w_down"])


def _dispatch_combine(xt, ew, local_e, pos, keep, gate, cap: int,
                      top_k: int):
    """Dispatch the (token, choice) pairs to the experts' buffers, run the
    experts, and combine: (N, D), each token's sum of its kept pairs'
    gate-weighted outputs. Pair i is token i // k's (see module doc)."""
    N, D = xt.shape
    n_e = ew["w_gate"].shape[0]
    rows = n_e * cap
    dest = torch.where(keep, local_e * cap + pos, rows).to(torch.int64)
    src = xt.repeat_interleave(top_k, dim=0)
    buf = xt.new_zeros((rows + 1, D)).index_copy(0, dest, src)
    ye = _experts(buf[:rows].view(n_e, cap, D), ew, xt.dtype)
    ye = torch.cat([ye.reshape(rows, D), ye.new_zeros((1, D))])
    y_tok = ye.index_select(0, dest) * gate[:, None]
    return y_tok.view(N, top_k, D).float().sum(dim=1).to(xt.dtype)


def moe_ffn(params, x, *, top_k: int, capacity_factor: float = 1.25,
            norm_topk_probs: bool = True):
    """x: (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    N = B * S
    xt = x.reshape(N, D)
    top_vals, top_idx = _route(xt, params["router"], top_k, norm_topk_probs)
    cap = _capacity(N, top_k, E, capacity_factor)
    flat_expert = top_idx.reshape(N * top_k)
    flat_gate = top_vals.reshape(N * top_k).to(x.dtype)
    everyone = torch.ones_like(flat_expert, dtype=torch.bool)
    pos = _positions(flat_expert, everyone, E)
    y = _dispatch_combine(xt, params["experts"], flat_expert, pos, pos < cap,
                          flat_gate, cap, top_k)
    if "shared" in params:
        y = y + shared_expert_ffn(params["shared"], xt)
    return y.reshape(B, S, D)


def shared_expert_ffn(sp, xt):
    """Dense always-on experts (computed outside the expert-parallel
    region: every rank runs them on the whole input)."""
    sg = xt @ sp["w_gate"]
    su = xt @ sp["w_up"]
    sh = F.silu(sg.float()).to(xt.dtype) * su
    return sh @ sp["w_down"]


# ---------------------------------------------------------------------------
# expert parallelism over the mesh of ranks
# ---------------------------------------------------------------------------
def _axis_names(axes) -> tuple:
    """A mesh axis name, a tuple of names or None, as a tuple of names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _label(axes) -> str:
    """The collectives' count label of ``axes`` (names joined by "+")."""
    return "+".join(_axis_names(axes))


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of every rank's ``t`` over ``group`` (one
    all-reduce, counted under ``label``). Backward: the identity. Every
    rank computes the same loss from the summed output, so each already
    holds the cotangent of its own part; an all-reduce of it
    (``torch.distributed.nn``'s) would scale the gradients by the group's
    size."""

    @staticmethod
    def forward(ctx, t, group, label):
        from repro_torch.sharding import world
        return world.all_reduce(t.clone(), group, label)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """Forward: the batch shards of ``ranks`` (in axis order) joined along
    dim 0 (one all-gather, counted under ``label``). Backward: this rank's
    shard of the cotangent (every rank holds the whole one)."""

    @staticmethod
    def forward(ctx, t, group, ranks, index, label):
        from repro_torch.sharding import world
        parts = world.all_gather(t, group, label)
        by_rank = dict(zip(sorted(ranks), parts))
        ctx.index, ctx.rows = index, t.shape[0]
        return torch.cat([by_rank[r] for r in ranks], dim=0)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None, None


class _LocalInputs(torch.autograd.Function):
    """Forward: this rank's inputs of the expert-parallel region — the
    router, experts ``[lo, lo + e_per)`` of each expert leaf, and rows
    ``[r0, r0 + b)`` of x — as views. Backward: each gradient placed in a
    zero tensor of its input's shape and summed over ``group`` (the ranks
    of the expert and batch axes) in ONE all-reduce of the packed float32
    gradients, so every rank holds the whole gradient, as the JAX
    package's ``shard_map`` transposes to."""

    @staticmethod
    def forward(ctx, group, label, lo, e_per, r0, b, router, wg, wu, wd, x):
        ctx.group, ctx.label, ctx.device = group, label, x.device
        ctx.lo, ctx.e_per, ctx.r0, ctx.b = lo, e_per, r0, b
        ctx.shapes = [(t.shape, t.dtype) for t in (router, wg, wu, wd, x)]
        return (router.view_as(router), wg[lo:lo + e_per],
                wu[lo:lo + e_per], wd[lo:lo + e_per], x[r0:r0 + b])

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.sharding import world
        spans = [None, (ctx.lo, ctx.e_per), (ctx.lo, ctx.e_per),
                 (ctx.lo, ctx.e_per), (ctx.r0, ctx.b)]
        full = []
        for g, (shape, dtype), span in zip(grads, ctx.shapes, spans):
            t = torch.zeros(shape, dtype=torch.float32, device=ctx.device)
            if g is not None:
                (t if span is None else
                 t[span[0]:span[0] + span[1]]).copy_(g)
            full.append(t)
        flat = torch.cat([t.reshape(-1) for t in full])
        if ctx.group is not None:
            world.all_reduce(flat, ctx.group, ctx.label)
        out, off = [], 0
        for (shape, dtype), t in zip(ctx.shapes, full):
            out.append(flat[off:off + t.numel()].view(shape).to(dtype))
            off += t.numel()
        return (None,) * 6 + tuple(out)


def _ep_local_dispatch(router, ew, xt, *, top_k, capacity_factor, E, e_per,
                       rank, group=None, label="model",
                       norm_topk_probs=True):
    """One rank's body: route its tokens, dispatch to ITS experts only
    (``rank * e_per`` onwards, ``ew`` holding those e_per), compute,
    combine, then sum over the expert axis's ``group`` (one all-reduce;
    none for a group of one rank)."""
    N, D = xt.shape
    top_vals, top_idx = _route(xt, router, top_k, norm_topk_probs)
    lo = rank * e_per
    cap = _capacity(N, top_k, E, capacity_factor)
    flat_expert = top_idx.reshape(N * top_k)
    flat_gate = top_vals.reshape(N * top_k).to(xt.dtype)
    mine = (flat_expert >= lo) & (flat_expert < lo + e_per)
    local_e = torch.where(mine, flat_expert - lo, 0)
    pos = _positions(local_e, mine, e_per)
    y = _dispatch_combine(xt, ew, local_e, pos, mine & (pos < cap),
                          flat_gate, cap, top_k)
    if group is None:
        return y
    return _SumOverRanks.apply(y, group, label)


def moe_ffn_ep(params, x, *, top_k: int, capacity_factor: float = 1.25,
               norm_topk_probs: bool = True):
    """Expert parallelism over the active rules' mesh of ranks (see the
    module doc); every rank calls it with the same arguments and returns
    the whole output. Falls back to ``moe_ffn`` when no rules are active,
    the mesh has no expert axis, or E does not divide over its ranks."""
    rules = sharding.active_rules()
    axis = rules.mapping.get("experts") if rules is not None else None
    mesh = rules.mesh if rules is not None else None
    E = params["router"].shape[1]
    kw = dict(top_k=top_k, capacity_factor=capacity_factor,
              norm_topk_probs=norm_topk_probs)
    if mesh is None or axis is None:
        return moe_ffn(params, x, **kw)
    n_ranks = sharding.axes_size(mesh, axis)
    if E % n_ranks != 0:
        return moe_ffn(params, x, **kw)
    e_per = E // n_ranks

    B, S, D = x.shape
    batch_axes = rules.mapping.get("batch")
    x_spec = sharding.fit_spec(sharding.PartitionSpec(batch_axes, None, None),
                               (B, S, D), mesh)
    me = world_rank()
    rank = mesh.axis_ranks(axis).index(me)
    data = x_spec[0]
    d_ranks = mesh.axis_ranks(data) if data is not None else (me,)
    index, b = d_ranks.index(me), B // len(d_ranks)
    both = tuple(dict.fromkeys(_axis_names(axis) + _axis_names(data)))

    ew = params["experts"]
    router, wg, wu, wd, x_local = _LocalInputs.apply(
        mesh.group(both), _label(both), rank * e_per, e_per, index * b,
        b, params["router"], ew["w_gate"], ew["w_up"], ew["w_down"], x)
    y = _ep_local_dispatch(
        router, {"w_gate": wg, "w_up": wu, "w_down": wd},
        x_local.reshape(b * S, D), e_per=e_per, E=E, rank=rank,
        group=mesh.group(axis), label=_label(axis), **kw)
    y = y.reshape(b, S, D)
    if len(d_ranks) > 1:
        y = _GatherRows.apply(y, mesh.group(data), d_ranks, index,
                              _label(data))
    if "shared" in params:
        y = y + shared_expert_ffn(params["shared"],
                                  x.reshape(B * S, D)).reshape(B, S, D)
    return y
