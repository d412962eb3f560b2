"""The rank side of ``tests/test_torch_sharded_chains.py``: one gloo world
of 4 CPU ranks runs every mesh case of that file once, and each rank
returns what it saw as NumPy values for the tests to hold against the JAX
package. No JAX here: the ranks are spawned processes that import only
torch and the port.

The mesh is the world's 4 ranks: ``ShardedRun.plan()`` lays them out 4 x 1
(chains only); ``plan(data_shards=2)`` 2 x 2, whose data groups are ranks
{0, 1} and {2, 3}; ``plan(data_shards=4)`` 1 x 4. NUTS and the
expert-parallel cases (``moe_ep``: ``tests/test_moe_ep.py``'s contracts
for ``moe_ffn_ep``) run on meshes of half the world: ranks {0, 1} and
{2, 3} each run one.
"""
import os

import numpy as np
import torch

DEV = "cpu"
GAUSS_N = 512          # tests/test_sharded_chains.py's size
LOGREG = dict(n=64, dim=5)


def _chain(ch):
    return {"draws": {k: np.asarray(ch[k]) for k in ch.names()},
            "stats": {k: np.asarray(v) for k, v in ch.stats.items()}}


def _models():
    from repro_torch.models import paper_suite
    return {"gauss_unknown": (paper_suite.build("gauss_unknown", n=GAUSS_N,
                                                device=DEV), ("y",)),
            "logreg": (paper_suite.build("logreg", device=DEV, **LOGREG),
                       ("X", "y"))}


def densities(points):
    """For each model and 2 and 4 data shards: the sharded value and
    gradient at ``points[model]`` (one call a point, and one batched
    ``value_and_grad`` of all of them), the local-only gradient (prior and
    this shard's likelihood, no all-reduce), and the collectives and
    evaluations of the batched call."""
    from repro_torch.kernels.fused_logpdf.ops import all_reduce_block_sum
    from repro_torch.sharding import (ShardedRun, make_sharded_logdensity,
                                      use_run, world)

    out = {}
    for name, (pm, sites) in _models().items():
        m = pm.model
        tvi = m.typed_varinfo(torch.Generator().manual_seed(0)).link()
        qs = torch.as_tensor(points[name])
        for shards in (2, 4):
            plan = ShardedRun.plan(data_shards=shards, shard_sites=sites)
            with use_run(plan):
                ld = make_sharded_logdensity(m, tvi, plan, device=DEV)
                values = [float(ld(q)) for q in qs]
                e0, c0 = ld.evaluations, world.COLLECTIVES.get("data", 0)
                vb, gb = ld.value_and_grad(qs)
                calls = (ld.evaluations - e0,
                         world.COLLECTIVES.get("data", 0) - c0)
                local = torch.stack([torch.func.grad(
                    lambda u: ld.prior(u) + ld.likelihood(u))(q) for q in qs])
                try:
                    torch.func.grad(lambda u: all_reduce_block_sum(
                        ld.likelihood(u), "data"))(qs[0])
                    refused = None
                except RuntimeError as exc:
                    refused = str(exc)
            out[(name, shards)] = {
                "repr": repr(plan), "values": np.asarray(values),
                "batched_values": vb.numpy(), "grads": gb.numpy(),
                "local_grads": local.numpy(), "calls": calls,
                "refused": refused,
                "rows": [tuple(x.shape) for x in ld.local]}
    return out


def chains_only():
    """HMC (no adaptation) on the 4 x 1 chains mesh and unsharded, and RWMH
    on the 2 x 2 chains x data mesh and unsharded, 6 draws each."""
    from repro_torch.infer import HMC, RWMH, run_chains
    from repro_torch.sharding import ShardedRun

    pm = _models()["gauss_unknown"][0]
    kern = HMC(step_size=0.05, n_leapfrog=3, adapt_step_size=False)
    kw = dict(num_chains=8, init_jitter=0.1, device=DEV)
    base = run_chains(11, pm.model, kern, 6, **kw)
    plan = ShardedRun.plan()
    sh = run_chains(11, pm.model, kern, 6, mesh=plan, **kw)
    rw = RWMH(proposal_scale=0.05)
    rw_base = run_chains(12, pm.model, rw, 6, **kw)
    rw_plan = ShardedRun.plan(data_shards=2, shard_sites=("y",))
    rw_sh = run_chains(12, pm.model, rw, 6, mesh=rw_plan, **kw)
    return {"plan": (plan.num_chain_devices, plan.num_data_shards),
            "base": _chain(base), "mesh": _chain(sh),
            "rwmh_base": _chain(rw_base), "rwmh_mesh": _chain(rw_sh)}


def reruns():
    """Two identical runs on the 2 x 2 mesh, then the cache's keys."""
    from repro_torch.core.program import program_cache
    from repro_torch.infer import HMC, run_chains
    from repro_torch.sharding import ShardedRun

    pm = _models()["gauss_unknown"][0]
    kern = HMC(step_size=0.05, n_leapfrog=2, adapt_step_size=False)
    plan = ShardedRun.plan(data_shards=2, shard_sites=("y",))
    a = run_chains(5, pm.model, kern, 4, num_chains=4, mesh=plan, device=DEV)
    b = run_chains(5, pm.model, kern, 4, num_chains=4, mesh=plan, device=DEV)
    h = b.health
    return {"a": _chain(a), "b": _chain(b),
            "second": (h.cache_misses, h.cache_retraces, h.cache_hits),
            "fingerprints": {"2x2": plan.fingerprint(),
                             "4x1": ShardedRun.plan().fingerprint()},
            "keys": sorted({(k.kind, k.sharding)
                            for k in program_cache().keys()}, key=repr)}


def mixing():
    """Adaptive HMC on the 2 x 2 mesh, 100 + 100 draws of 8 chains, with
    the collectives and gradient evaluations of the run."""
    from repro_torch.core.program import program_cache
    from repro_torch.infer import HMC, run_chains
    from repro_torch.sharding import ShardedLogDensity, ShardedRun, world

    pm = _models()["gauss_unknown"][0]
    kern = HMC(step_size=pm.step_size, n_leapfrog=4, adapt_step_size=True)
    plan = ShardedRun.plan(data_shards=2, shard_sites=("y",))

    def evaluations():
        return sum(p.evaluations for k in program_cache().keys()
                   if isinstance(p := program_cache().get(k),
                                 ShardedLogDensity))

    e0, c0 = evaluations(), dict(world.COLLECTIVES)
    ch = run_chains(1, pm.model, kern, 100, num_warmup=100, num_chains=8,
                    mesh=plan, device=DEV)
    return {"chain": _chain(ch), "misses": ch.health.cache_misses,
            "evaluations": evaluations() - e0,
            "collectives": {k: v - c0.get(k, 0)
                            for k, v in world.COLLECTIVES.items()},
            "y": np.asarray(pm.data["y"])}


def resume(root):
    """A chains-only segmented run uninterrupted, preempted and resumed on
    the 4 x 1 mesh; an unsharded run's snapshot resumed on the mesh; a NaN
    injected at transition 15, on the mesh and unsharded (the segment
    rerun on the reference twin)."""
    from repro_torch.infer import HMC, run_chains
    from repro_torch.runtime import NaNInjector, ScriptedPreemption
    from repro_torch.sharding import ShardedRun

    pm = _models()["gauss_unknown"][0]
    kern = HMC(step_size=0.05, n_leapfrog=2, adapt_step_size=True)
    plan = ShardedRun.plan()
    kw = dict(num_warmup=10, num_chains=8, checkpoint_every=10, device=DEV)
    full = run_chains(9, pm.model, kern, 30, mesh=plan,
                      checkpoint_dir=os.path.join(root, "full"), **kw)
    d_int = os.path.join(root, "int")
    part = run_chains(9, pm.model, kern, 30, mesh=plan, checkpoint_dir=d_int,
                      preemption=ScriptedPreemption(after_polls=1), **kw)
    res = run_chains(9, pm.model, kern, 30, mesh=plan, checkpoint_dir=d_int,
                     **kw)
    # a snapshot of the unsharded run, written by rank 0 alone, resumed on
    # the mesh
    d_one = os.path.join(root, "one")
    alone = run_chains(9, pm.model, kern, 30, **kw)
    if torch.distributed.get_rank() == 0:
        run_chains(9, pm.model, kern, 30, checkpoint_dir=d_one,
                   preemption=ScriptedPreemption(after_polls=2), **kw)
    torch.distributed.barrier()
    moved = run_chains(9, pm.model, kern, 30, mesh=plan,
                       checkpoint_dir=d_one, **kw)
    nan = NaNInjector(kern, at_iterations=[15])
    nan_mesh = run_chains(9, pm.model, nan, 30, mesh=plan, **kw)
    nan_alone = run_chains(9, pm.model, nan, 30, **kw)
    return {"full": _chain(full), "res": _chain(res), "alone": _chain(alone),
            "moved": _chain(moved),
            "part": (part.health.preempted, part.health.completed),
            "resumed_from": (res.health.resumed_from, res.health.preempted),
            "moved_from": moved.health.resumed_from,
            "nan_mesh": _chain(nan_mesh), "nan_alone": _chain(nan_alone),
            "nan_health": [(h.fallback_segments, int(h.nonfinite.sum()))
                           for h in (nan_mesh.health, nan_alone.health)]}


def errors():
    """The refusals, before any collective."""
    from repro_torch.infer import HMC, run_chains
    from repro_torch.sharding import ShardedRun

    pm = _models()["gauss_unknown"][0]
    out = {}
    cases = {
        "segments": (ShardedRun.plan(data_shards=4, shard_sites=("y",)),
                     dict(num_chains=8, checkpoint_every=5)),
        "indivisible": (ShardedRun.plan(), dict(num_chains=6))}
    for name, (plan, kw) in cases.items():
        try:
            run_chains(0, pm.model, HMC(), 10, mesh=plan, device=DEV, **kw)
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def dtensor():
    """``constrain`` under rules with a mesh: a DTensor is redistributed
    over its device mesh (an axis that does not divide the dim dropped), a
    plain tensor returned as it is."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.sharding import Rules, ShardedRun, constrain, use_rules

    plan = ShardedRun.plan(data_shards=2, shard_sites=("y",))
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("chains", "data"))
    out = {}
    for label, rule, rows in (("data", "data", 8),
                              ("both", ("chains", "data"), 8),
                              ("indivisible", "data", 3)):
        x = distribute_tensor(torch.arange(rows * 2.0).reshape(rows, 2), dm,
                              [Replicate(), Replicate()])
        plain = torch.ones(rows, 2)
        with use_rules(Rules({"batch": rule}).with_mesh(plan.mesh)):
            y = constrain(x, "batch", None)
            kept = constrain(plain, "batch", None) is plain
        out[label] = {"placements": tuple(str(p) for p in y.placements),
                      "local": tuple(y.to_local().shape),
                      "full": y.full_tensor().numpy(), "plain_kept": kept}
    return out


def nuts(rank):
    """NUTS on a 1 x 2 data mesh: ranks {0, 1} and {2, 3} each run one,
    on meshes of half the world."""
    from repro_torch.infer import NUTS, run_chains
    from repro_torch.sharding import ShardedRun, world

    pm = _models()["gauss_unknown"][0]
    pair = [0, 1] if rank < 2 else [2, 3]
    plan = ShardedRun.plan(devices=pair, data_shards=2, shard_sites=("y",))
    c0 = world.COLLECTIVES.get("data", 0)
    ch = run_chains(3, pm.model, NUTS(step_size=0.05, max_depth=4), 10,
                    num_warmup=10, num_chains=2, mesh=plan, device=DEV)
    return {"chain": _chain(ch), "pair": pair,
            "shape": (plan.num_chain_devices, plan.num_data_shards),
            "collectives": world.COLLECTIVES.get("data", 0) - c0}


# the expert-parallel cases: x (2, 16, 32), 8 experts of 64, top-2, one
# shared expert of 64
MOE = dict(d_model=32, n_experts=8, top_k=2, d_expert=64, d_shared=64)


def moe_case():
    """``moe_ffn``'s weights (seeded by path, float32), x and the cotangent
    w of ``sum(y * w)``, as NumPy: the same on every rank and in the test
    that holds them against the JAX package."""
    from repro_torch.nn import moe
    from repro_torch.nn.common import Initializer

    init = Initializer(0, torch.float32, "cpu")
    params = moe.init_moe_params(init, "m", MOE["d_model"], MOE["d_expert"],
                                 MOE["n_experts"], n_shared=1,
                                 d_shared=MOE["d_shared"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, MOE["d_model"])).astype(np.float32)
    w = rng.standard_normal((2, 16, MOE["d_model"])).astype(np.float32)
    return as_numpy(params), x, w


def moe_drops(params, x, factor):
    """(Token, choice) pairs the capacity drops in ``moe_case``, counted in
    NumPy."""
    k, n_experts = MOE["top_k"], MOE["n_experts"]
    logits = x.reshape(-1, x.shape[-1]) @ params["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :k].reshape(-1)
    cap = int(np.ceil(top.size / n_experts * factor))
    counts = np.bincount(top, minlength=n_experts)
    return int(np.maximum(counts - cap, 0).sum())


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def as_leaf_tensors(tree):
    """Each NumPy leaf as a new tensor that requires grad."""
    if isinstance(tree, dict):
        return {k: as_leaf_tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree).clone().requires_grad_(True)


def moe_leaves(tree):
    """Leaves in sorted-key order, as ``jax.tree_util`` flattens a dict."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in moe_leaves(tree[k])]
    return [tree]


def _value_and_grads(fn, rules, **kw):
    from repro_torch.sharding import use_rules

    params_np, x_np, w_np = moe_case()
    params, x = as_leaf_tensors(params_np), as_leaf_tensors(x_np)
    with use_rules(rules):
        y = fn(params, x, **kw)
    grads = torch.autograd.grad((y * torch.as_tensor(w_np)).sum(),
                                moe_leaves(params) + [x])
    return y.detach().numpy(), [g.numpy() for g in grads]


def moe_ep(rank):
    """``moe_ffn_ep`` on a data 1 x model 2 mesh (the default capacity,
    drops included) and a data 2 x model 1 mesh (capacity E / k), each
    beside the one-process ``moe_ffn`` on the same inputs, with the
    gradients of ``sum(y * w)`` and the collectives counted; then
    deepseek's smoke config with ``moe_impl="ep"`` on the 1 x 2 mesh
    beside its gspmd dispatch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.nn import lm, moe
    from repro_torch.sharding import DEFAULT_RULES, Mesh, use_rules, world

    pair = np.array([0, 1] if rank < 2 else [2, 3])
    meshes = {"1x2": (pair.reshape(1, 2), 1.25),
              "2x1": (pair.reshape(2, 1), MOE["n_experts"] / MOE["top_k"])}

    def counted(fn):
        c0 = dict(world.COLLECTIVES)
        out = fn()
        return out, {k: v - c0.get(k, 0) for k, v in world.COLLECTIVES.items()
                     if v != c0.get(k, 0)}

    out = {"pair": pair.tolist()}
    for label, (grid, factor) in meshes.items():
        rules = DEFAULT_RULES.with_mesh(Mesh(grid, ("data", "model")))
        kw = dict(top_k=MOE["top_k"], capacity_factor=factor)
        (y_ep, g_ep), counts = counted(
            lambda: _value_and_grads(moe.moe_ffn_ep, rules, **kw))
        y, g = _value_and_grads(moe.moe_ffn, None, **kw)
        out[label] = {"y_ep": y_ep, "grads_ep": g_ep, "y": y, "grads": g,
                      "collectives": counts}

    cfg = dataclasses.replace(
        configs.get_smoke_config("deepseek-v2-lite-16b"), moe_impl="ep")
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    rules = DEFAULT_RULES.with_mesh(Mesh(meshes["1x2"][0],
                                         ("data", "model")))
    with torch.no_grad():
        with use_rules(rules):
            ep, counts = counted(
                lambda: lm.forward_train(cfg, params, tokens))
        gspmd = lm.forward_train(dataclasses.replace(cfg, moe_impl="gspmd"),
                                 params, tokens)
    out["deepseek"] = {"ep": ep.numpy(), "gspmd": gspmd.numpy(),
                       "collectives": counts,
                       "moe_layers": cfg.n_layers - cfg.first_dense}
    return out


def run_world(rank, world_size, root, points):
    """Every case in turn, on every rank."""
    torch.set_num_threads(1)
    out = {"rank": rank, "world_size": world_size,
           "backend": torch.distributed.get_backend()}
    out["densities"] = densities(points)
    out["chains_only"] = chains_only()
    out["reruns"] = reruns()
    out["mixing"] = mixing()
    out["resume"] = resume(root)
    out["errors"] = errors()
    out["dtensor"] = dtensor()
    out["nuts"] = nuts(rank)
    out["moe_ep"] = moe_ep(rank)
    return out
