"""PyTorch port: ``repro_torch.sharding``'s pure spec logic and mesh plan
against ``repro.sharding``'s, with no world.

``Rules``, ``with_mesh``, ``spec``, ``fit_spec``, ``param_spec_for``
(tensor-parallel, the divisibility fallback, experts, FSDP),
``named_sharding`` and ``param_shardings`` (its specs and
``torch.distributed.tensor`` placements), ``ShardedRun``'s validation
messages, geometry and ``fingerprint``, and ``shard_slices``' messages:
each on the same ``FakeMesh`` (``axis_names`` and ``devices.shape``, which
both packages read) and inputs as ``repro``'s, the port's canonical
``PartitionSpec`` against ``jax.sharding.PartitionSpec`` as a tuple. Every
leaf of ``repro``'s smoke LM parameter trees (shapes from
``jax.eval_shape``) goes through both, the port's walked by
``torch.utils._pytree`` paths, and for the archs the port has, its own
``init_params`` tree too. ``Rules.with_mesh`` is held to the contract of
``tests/test_sharding.py:83-108``, which ``repro``'s own output misses
today (its ``PartitionSpec`` no longer tells ``('a',)`` from ``'a'``).
"""
import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_flatten_with_path

from repro import configs as jconfigs
from repro import sharding as jsh
from repro.models import paper_suite as jsuite
from repro.nn import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import sharding as tsh
from repro_torch.models import paper_suite as tsuite
from repro_torch.nn import lm as tlm
from repro_torch.sharding import PartitionSpec as P
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape)


MESH = FakeMesh((16, 16), ("data", "model"))
PODMESH = FakeMesh((2, 16, 16), ("pod", "data", "model"))
INFER = FakeMesh((2, 4), ("chains", "data"))
MESHES = {"data_model": MESH, "pod": PODMESH, "chains_data": INFER}
PORTED = ("smollm-360m", "minitron-4b", "granite-8b", "gemma2-27b",
          "internvl2-26b", "mamba2-1.3b", "seamless-m4t-large-v2")


class K:
    def __init__(self, k):
        self.key = k


def _ours(spec):
    """``repro``'s spec as the port's."""
    return P(*tuple(spec))


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------
def test_rule_sets_match():
    for name in ("DEFAULT_RULES", "LONG_DECODE_RULES"):
        ours, ref = getattr(tsh, name), getattr(jsh, name)
        assert ours.mapping == ref.mapping and ours.fsdp == ref.fsdp
    assert tsh.FSDP_MIN_SIZE == jsh.FSDP_MIN_SIZE


@pytest.mark.parametrize("mesh", list(MESHES))
def test_with_mesh_matches_the_reference(mesh):
    m = MESHES[mesh]
    for name in ("DEFAULT_RULES", "LONG_DECODE_RULES"):
        ours = getattr(tsh, name).with_mesh(m)
        ref = getattr(jsh, name).with_mesh(m)
        assert ours.mapping == ref.mapping and ours.mesh is m
        logical = ("batch", "seq", "heads", "mlp", "kv_seq", "embed")
        assert ours.spec(*logical) == _ours(ref.spec(*logical))


def test_with_mesh_contract():
    """tests/test_sharding.py:83-108: unknown axes dropped, a surviving
    1-tuple the bare axis name, the spec canonical, the mesh kept."""
    r = tsh.Rules({
        "batch": ("pod", "data"),
        "heads": "model",
        "mlp": "tensor",
        "experts": ("ep", "tp"),
        "seq": None,
        "state": ("data", "model"),
    }).with_mesh(MESH)
    assert r.mapping["batch"] == "data"
    assert not isinstance(r.mapping["batch"], tuple)
    assert r.mapping["heads"] == "model"
    assert r.mapping["mlp"] is None
    assert r.mapping["experts"] is None
    assert r.mapping["seq"] is None
    assert r.mapping["state"] == ("data", "model")
    assert r.spec("batch") == P("data")
    # the port's spec is canonical: one sharding, one form
    assert P(("data",)) == P("data") and P(()) == P(None)
    assert r.mesh is MESH


def test_with_mesh_of_inference_mesh_axes():
    r = tsh.DEFAULT_RULES.with_mesh(INFER)
    for k, v in r.mapping.items():
        assert v is None or v == "data", (k, v)
    assert r.mapping["batch"] == "data"


def test_partition_spec_is_a_tuple_that_pickles():
    s = P(("pod", "data"), None, ["model"])
    assert s == (("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(s)) == s
    assert type(pickle.loads(pickle.dumps(s))) is P
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_spec_under_use_rules():
    assert tsh.spec("batch", "embed") == P() == _ours(jsh.spec("batch"))
    with tsh.use_rules(tsh.DEFAULT_RULES.with_mesh(MESH)), \
            jsh.use_rules(jsh.DEFAULT_RULES.with_mesh(MESH)):
        assert tsh.active_rules() is not None
        assert tsh.spec("batch", "embed", "heads") == _ours(
            jsh.spec("batch", "embed", "heads"))
    assert tsh.active_rules() is None


FIT_CASES = [(("model", "data"), (15, 32), "data_model"),
             ((("pod", "data"),), (48,), "pod"),
             ((("pod", "data"),), (64,), "pod"),
             (("data", None, "model"), (32, 3, 48), "data_model"),
             (("chains", "data"), (6, 8), "chains_data")]


@pytest.mark.parametrize("spec,shape,mesh", FIT_CASES)
def test_fit_spec_matches_the_reference(spec, shape, mesh):
    m = MESHES[mesh]
    assert tsh.fit_spec(P(*spec), shape, m) == _ours(
        jsh.fit_spec(JP(*spec), shape, m))
    assert tsh.fit_spec(P(*spec), shape, None) == P(*spec)
    for ax in ("data", "model", ("pod", "data"), None):
        if ax is None or all(a in m.axis_names
                             for a in ((ax,) if isinstance(ax, str) else ax)):
            assert tsh.axes_size(m, ax) == jsh.axes_size(m, ax)


SPEC_CASES = [
    # tensor-parallel
    (["attn", "wq"], (4096, 32, 128)), (["attn", "wo"], (32, 128, 4096)),
    (["mlp", "w_gate"], (4096, 14336)), (["mlp", "w_down"], (14336, 4096)),
    (["embed_table"], (49152, 4096)), (["ln1"], (4096,)),
    # divisibility fallback
    (["attn", "wq"], (960, 15, 64)), (["attn", "wk"], (960, 5, 64)),
    (["embed_table"], (49155, 1024)),
    # experts, and stacked
    (["moe", "experts", "w_gate"], (64, 2048, 1408)),
    (["moe", "experts", "w_gate"], (13, 64, 2048, 1408)),
    (["moe", "router"], (2048, 64)), (["segments", "attn", "wq"],
                                      (4, 4096, 32, 128)),
]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_spec_for_matches_the_reference(mesh, fsdp):
    m = MESHES[mesh]
    ours = tsh.DEFAULT_RULES.with_mesh(m).with_fsdp(fsdp)
    ref = jsh.DEFAULT_RULES.with_mesh(m).with_fsdp(fsdp)
    for keys, shape in SPEC_CASES:
        want = _ours(jsh.param_spec_for([K(k) for k in keys], shape, ref))
        assert tsh.param_spec_for([K(k) for k in keys], shape, ours) == want
        assert tsh.param_spec_for(keys, shape, ours) == want  # plain keys


def test_param_specs_tensor_parallel():
    r = tsh.DEFAULT_RULES.with_mesh(MESH)
    assert tsh.param_spec_for(["attn", "wq"], (4096, 32, 128), r) == \
        P(None, "model", None)
    assert tsh.param_spec_for(["attn", "wq"], (960, 15, 64), r) == \
        P(None, None, None)
    s = tsh.param_spec_for(["attn", "wq"], (4096, 32, 128), r.with_fsdp())
    assert s == P("data", "model", None)


def _jax_shapes(arch):
    return jax.eval_shape(functools.partial(
        jlm.init_params, jconfigs.get_smoke_config(arch), 0))


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_every_lm_leaf_matches_the_reference(arch):
    """Every leaf of ``repro``'s smoke parameter tree, on each mesh, with
    and without FSDP: ``repro``'s ``param_spec_for`` on its JAX paths
    equals the port's ``param_shardings`` on ``torch.utils._pytree``'s
    paths of the same tree, and (for the archs the port has) on its own
    ``init_params`` tree; every placement is the spec's."""
    shapes = _jax_shapes(arch)
    own = (tlm.init_params(tconfigs.get_smoke_config(arch), device="meta")
           if arch in PORTED else None)
    for m in MESHES.values():
        for fsdp in (False, True):
            ref_rules = jsh.DEFAULT_RULES.with_fsdp(fsdp).with_mesh(m)
            want = {_path_str(p): _ours(jsh.param_spec_for(
                p, tuple(leaf.shape), ref_rules))
                for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
            rules = tsh.DEFAULT_RULES.with_fsdp(fsdp)
            trees = [shapes] + ([own] if own is not None else [])
            for tree in trees:
                got, _ = tree_flatten_with_path(
                    tsh.param_shardings(m, tree, rules),
                    is_leaf=lambda x: isinstance(x, tsh.NamedSharding))
                got = {_path_str(p): ns for p, ns in got}
                assert set(got) == set(want)
                for path, ns in got.items():
                    assert ns.spec == want[path], (path, ns.spec, want[path])
                    assert ns.placements == tsh.placements_for(
                        want[path], m.axis_names)


def test_placements():
    r = tsh.DEFAULT_RULES.with_mesh(PODMESH)
    ns = tsh.named_sharding(PODMESH, "batch", "embed", "heads", rules=r)
    assert ns.spec == _ours(jsh.DEFAULT_RULES.with_mesh(PODMESH).spec(
        "batch", "embed", "heads"))
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    wq = tsh.param_shardings(MESH, {"attn": {"wq": torch.empty(
        4096, 32, 128, device="meta")}}, tsh.DEFAULT_RULES)["attn"]["wq"]
    assert wq.spec == P(None, "model", None)
    assert wq.placements == (Replicate(), Shard(1))
    assert tsh.named_sharding(MESH, "embed").placements == (
        Replicate(), Replicate())


def test_constrain_is_the_identity_off_a_dtensor():
    x = torch.ones(32, 8)
    assert tsh.constrain(x, "batch", None) is x
    with tsh.use_rules(tsh.DEFAULT_RULES):  # no mesh
        assert tsh.constrain(x, "batch", None) is x
    with tsh.use_rules(tsh.DEFAULT_RULES.with_mesh(MESH)):
        assert tsh.constrain(x, "batch", None) is x


# ---------------------------------------------------------------------------
# the mesh plan
# ---------------------------------------------------------------------------
def _raises_alike(ours, ref, exc=ValueError):
    with pytest.raises(exc) as a:
        ours()
    with pytest.raises(exc) as b:
        ref()
    assert str(a.value) == str(b.value)
    return str(a.value)


def test_sharded_run_validation_messages():
    _raises_alike(lambda: tsh.ShardedRun(FakeMesh((2, 2), ("chains", "m"))),
                  lambda: jsh.ShardedRun(FakeMesh((2, 2), ("chains", "m"))))
    _raises_alike(lambda: tsh.ShardedRun(INFER),
                  lambda: jsh.ShardedRun(INFER))
    _raises_alike(lambda: tsh.ShardedRun.plan(devices=[0], data_shards=3),
                  lambda: jsh.ShardedRun.plan(devices=jax.devices()[:1],
                                              data_shards=3))
    _raises_alike(lambda: tsh.ShardedRun.plan(devices=[0], data_shards=0),
                  lambda: jsh.ShardedRun.plan(devices=jax.devices()[:1],
                                              data_shards=0))
    _raises_alike(lambda: tsh.ShardedRun.plan(devices=[0] * 4,
                                              data_shards=4),
                  lambda: jsh.ShardedRun.plan(devices=jax.devices() * 4,
                                              data_shards=4))
    plan = (tsh.ShardedRun(INFER, shard_sites=("y",)),
            jsh.ShardedRun(INFER, shard_sites=("y",)))
    msg = _raises_alike(lambda: plan[0].validate_chains(7),
                        lambda: plan[1].validate_chains(7))
    assert "not divisible" in msg
    plan[0].validate_chains(8)
    with pytest.raises(TypeError):
        tsh.ShardedRun.normalize(object())


def test_sharded_run_geometry_and_fingerprint():
    for shape, sites in (((2, 4), ("y",)), ((4, 1), ()), ((1, 1), ())):
        mesh = FakeMesh(shape, ("chains", "data"))
        ours = tsh.ShardedRun(mesh, shard_sites=sites)
        ref = jsh.ShardedRun(mesh, shard_sites=sites)
        assert ours.fingerprint() == ref.fingerprint()
        assert hash(ours.fingerprint())
        for attr in ("num_chain_devices", "num_data_shards", "num_devices",
                     "is_trivial"):
            assert getattr(ours, attr) == getattr(ref, attr)
        if sites:  # a raw mesh with data shards names no sites
            _raises_alike(lambda: tsh.ShardedRun.normalize(mesh),
                          lambda: jsh.ShardedRun.normalize(mesh))
            continue
        n = tsh.ShardedRun.normalize(mesh)
        r = jsh.ShardedRun.normalize(mesh)
        assert (n.chain_axis, n.data_axis) == (r.chain_axis, r.data_axis)
        assert n.fingerprint() == r.fingerprint()
    assert tsh.ShardedRun.normalize(None) is None
    one = tsh.ShardedRun.normalize(tsh.Mesh(np.arange(3), ("chains",)))
    assert (one.num_chain_devices, one.num_data_shards) == (3, 1)


def test_plan_is_trivial_without_a_world():
    plan = tsh.ShardedRun.plan()
    assert plan.is_trivial and plan.fingerprint()[1] == (1, 1)
    assert tsh.ShardedRun.plan(shard_sites=()).fingerprint() == \
        plan.fingerprint()
    assert repr(plan) == ("ShardedRun(chains=1 x data=1, shard_sites=[], "
                          "backend=none (no world))")
    assert plan.coords() == (0, 0) and plan.chain_rows(4) == slice(0, 4)
    assert tsh.active_run() is None
    with tsh.use_run(plan):
        assert tsh.active_run() is plan
    assert tsh.active_run() is None


def test_local_rank_follows_the_host_not_the_world(monkeypatch):
    """A rank's card is picked by its index among its host's ranks
    (``LOCAL_RANK`` as ``torchrun`` sets it), not by its world rank."""
    from repro_torch.sharding import world

    monkeypatch.setattr(world, "_LOCAL_RANK", None)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert world.local_rank() == 0
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert world.local_rank() == 3
    monkeypatch.setattr(world, "_LOCAL_RANK", 1)
    assert world.local_rank() == 1
    assert tsh.ShardedRun.plan().device("cpu") == torch.device("cpu")


def test_mesh_ranks_and_coordinates():
    mesh = tsh.Mesh(np.array([[3, 1], [0, 2]]), ("chains", "data"))
    assert mesh.shape == {"chains": 2, "data": 2}
    assert mesh.coords(2) == (1, 1)
    assert mesh.axis_ranks("chains", 1) == (1, 2)
    assert mesh.axis_ranks("data", 0) == (0, 2)
    assert mesh.axis_ranks(None) == (3, 1, 0, 2)
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.coords(7)
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        mesh.group("chains")


def test_trivial_mesh_degrades_to_single_device_path():
    """``mesh=`` a trivial plan reuses the single-device programs (no new
    miss) and gives the same draws bit for bit; a mesh of several ranks
    outside a world is refused before anything runs."""
    from repro_torch.core.program import program_cache
    from repro_torch.infer import HMC, run_chains

    pm = tsuite.build("gauss_unknown", n=512, device="cpu")
    kern = HMC(step_size=0.05, n_leapfrog=2, adapt_step_size=False)
    a = run_chains(3, pm.model, kern, 5, num_chains=2, device="cpu")
    misses = program_cache().stats()["misses"]
    b = run_chains(3, pm.model, kern, 5, num_chains=2, device="cpu",
                   mesh=tsh.ShardedRun.plan())
    assert program_cache().stats()["misses"] == misses
    for k in a.names():
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        run_chains(3, pm.model, kern, 5, num_chains=2, device="cpu",
                   mesh=tsh.ShardedRun.plan(devices=[0, 1]))
    with pytest.raises(TypeError, match="Mesh"):
        run_chains(3, pm.model, kern, 5, num_chains=2, device="cpu",
                   mesh=FakeMesh((2, 1), ("chains", "data")))


def test_all_reduce_block_sum_seam():
    from repro_torch.kernels.fused_logpdf.ops import all_reduce_block_sum
    x = torch.tensor(3.0)
    assert all_reduce_block_sum(x) is x
    with pytest.raises(RuntimeError, match="active ShardedRun"):
        all_reduce_block_sum(x, "data")


# ---------------------------------------------------------------------------
# shard_slices
# ---------------------------------------------------------------------------
def _tiny_models():
    from repro import model as jmodel, observe as jobserve, sample as jsample
    from repro.dists import Normal as JNormal
    from repro_torch import model as tmodel, observe as tobserve
    from repro_torch import sample as tsample
    from repro_torch.dists import Normal as TNormal

    def make(model, sample, observe, Normal, asarray):
        @model
        def tiny(y, c):
            mu = sample("mu", Normal(0.0, 1.0))
            observe("y", Normal(mu + c, 1.0), y)
        y = np.arange(6, dtype=np.float32)
        return tiny(asarray(y), 0.5)

    import jax.numpy as jnp
    return (make(tmodel, tsample, tobserve, TNormal, torch.as_tensor),
            make(jmodel, jsample, jobserve, JNormal, jnp.asarray))


def test_shard_slices_match_the_reference():
    ours, ref = _tiny_models()
    for sites, shards in ((("y",), 2), (("y",), 3), (("y",), 6)):
        assert tsh.shard_slices(ours, sites, shards) == \
            jsh.shard_slices(ref, sites, shards)
    for sites, shards in ((("nope",), 2), (("c",), 2), (("y",), 4)):
        _raises_alike(lambda: tsh.shard_slices(ours, sites, shards),
                      lambda: jsh.shard_slices(ref, sites, shards))
    pm_t = tsuite.build("logreg", n=64, dim=5, device="cpu")
    pm_j = jsuite.build("logreg", n=64, dim=5)
    assert tsh.shard_slices(pm_t.model, ("X", "y"), 4) == \
        jsh.shard_slices(pm_j.model, ("X", "y"), 4) == \
        {"X": (64, 16), "y": (64, 16)}
