"""PyTorch port: ``run_chains(mesh=)`` over a world of ranks
(``repro_torch.sharding``), held to ``tests/test_sharded_chains.py``'s
contracts.

One gloo world of 4 CPU ranks, spawned once for the module
(``repro_torch.sharding.spawn_world``: a ``FileStore`` in a temporary
directory, a time limit that kills every rank and fails), runs every mesh
case of ``tests/_torch_dist.py`` (no JAX there); the tests below hold what
each rank returned against the JAX package on the same NumPy data. The
world is spawned from a thread when the module is imported, so its ranks
run on other cores while pytest collects and runs the modules before this
one; the ``ranks`` fixture waits for it.

* the sharded density (2 and 4 data shards) against ``repro``'s UNSHARDED
  ``make_logdensity_fn`` at 1e-6 relative, and its gradient against
  ``jax.grad`` of it at 1e-5 (the local-only gradient, which leaves out the
  other ranks' shards, misses it), on gauss_unknown at n = 512 (that
  file's size) and a small logreg;
* exactly one collective a gradient evaluation, and none under a
  ``torch.func`` transform;
* chains-only draws against the unsharded run at 1e-4, every rank
  returning the whole fleet; reruns bit for bit with no second miss; the
  ``ProgramKey`` sharding component; a 2 x 2 run that mixes (that file's
  5-sigma gate); the mesh resume bit for bit; the data-plus-segments and
  indivisible-chains errors (``repro``'s messages); NUTS on 1 x 2 meshes
  (finite, ranks identical);
* ``tests/test_moe_ep.py``'s contracts for ``moe_ffn_ep`` on meshes of
  half the world (``_torch_dist.moe_ep``): equal to ``moe_ffn`` at 1e-6
  on a data 1 x model 2 mesh at the default capacity (pairs dropped) and
  on data 2 x model 1 at capacity E / k, gradients included, with one
  all-reduce over the expert axis a layer; deepseek's smoke config with
  ``moe_impl="ep"`` finite and equal to the gspmd dispatch.
"""
import atexit
import shutil
import tempfile
import threading

import jax
import numpy as np
import pytest

from repro.models import paper_suite as jsuite
from repro.sharding import ShardedRun as JShardedRun
from repro_torch.sharding import spawn_world
import _torch_dist
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401
from _jax_reference import moe_ffn_reference

WORLD = 4
DATA_GROUPS = ((0, 1), (2, 3))  # plan(data_shards=2): [[0, 1], [2, 3]]


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape)


def _points():
    rng = np.random.default_rng(0)
    gauss = np.array([[0.1, 1.2], [0.4, 1.5], [-0.2, 1.0], [0.25, 1.6]],
                     np.float32)
    dim = _torch_dist.LOGREG["dim"] + 1
    logreg = (0.3 * rng.standard_normal((4, dim))).astype(np.float32)
    return {"gauss_unknown": gauss, "logreg": logreg}


POINTS = _points()


def _spawn_in_background():
    """Start the module's world in a daemon thread: (thread, result box).
    Its temporary directory goes at exit, whether the tests ran or not."""
    root = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    box = {}

    def run():
        try:
            box["ranks"] = spawn_world(
                _torch_dist.run_world, WORLD,
                args=(root, POINTS), device="cpu",
                timeout_s=240.0, store_dir=root)
        except BaseException as exc:  # noqa: BLE001 - raised by the fixture
            box["error"] = exc

    thread = threading.Thread(target=run, name="mesh-world", daemon=True)
    thread.start()
    return thread, box


_WORLD = _spawn_in_background()


@pytest.fixture(scope="module")
def ranks():
    thread, box = _WORLD
    thread.join()
    if "error" in box:
        raise box["error"]
    out = box["ranks"]
    assert [r["rank"] for r in out] == list(range(WORLD))
    assert all(r["backend"] == "gloo" for r in out)
    return out


def _reference(name):
    """``repro``'s unsharded density and its ``jax.grad`` at ``POINTS``."""
    if name == "gauss_unknown":
        pm = jsuite.build(name, n=_torch_dist.GAUSS_N)
    else:
        pm = jsuite.build(name, **_torch_dist.LOGREG)
    tvi = pm.model.typed_varinfo(jax.random.PRNGKey(0)).link()
    ld = pm.model.make_logdensity_fn(tvi)
    vg = jax.jit(jax.vmap(jax.value_and_grad(ld)))
    v, g = vg(jax.numpy.asarray(POINTS[name]))
    return np.asarray(v, np.float64), np.asarray(g, np.float64)


CASES = [(m, s) for m in ("gauss_unknown", "logreg") for s in (2, 4)]


@pytest.fixture(scope="module")
def references():
    return {m: _reference(m) for m in ("gauss_unknown", "logreg")}


def _same(a, b):
    for k in a["draws"]:
        np.testing.assert_array_equal(a["draws"][k], b["draws"][k])
    for k in a["stats"]:
        np.testing.assert_array_equal(a["stats"][k], b["stats"][k])


@pytest.mark.parametrize("name,shards", CASES)
def test_sharded_density_matches_the_unsharded_reference(ranks, references,
                                                         name, shards):
    """Every rank's sharded density, one call a point and batched, within
    1e-6 relative of ``repro``'s unsharded ``make_logdensity_fn``; each
    rank holds ``rows / shards`` of every shard site."""
    want, _ = references[name]
    full = _torch_dist.GAUSS_N if name == "gauss_unknown" else \
        _torch_dist.LOGREG["n"]
    for r in ranks:
        got = r["densities"][(name, shards)]
        assert all(rows[0] == full // shards for rows in got["rows"])
        for v in (got["values"], got["batched_values"]):
            err = np.abs(v - want) / np.maximum(np.abs(want), 1.0)
            assert err.max() <= 1e-6, (r["rank"], v, want)


@pytest.mark.parametrize("name,shards", CASES)
def test_sharded_gradient_matches_jax_grad(ranks, references, name, shards):
    """The batched ``value_and_grad`` (one all-reduce of the packed
    likelihood values and gradients) within 1e-5 of ``jax.grad`` of the
    unsharded density; the local-only gradient misses it."""
    _, want = references[name]
    tol = 1e-5 * np.maximum(np.abs(want), 1.0)
    for r in ranks:
        got = r["densities"][(name, shards)]
        assert (np.abs(got["grads"] - want) <= tol).all(), r["rank"]
        assert not (np.abs(got["local_grads"] - want) <= tol).all()


def test_one_collective_per_gradient_evaluation(ranks):
    """A batched ``value_and_grad`` of 4 points is one evaluation and one
    collective; a 2 x 2 adaptive run makes one data-axis collective a
    gradient evaluation and none along the chain axis but the packaging's
    all-gather."""
    for r in ranks:
        for case in r["densities"].values():
            assert case["calls"] == (1, 1)
        mix = r["mixing"]
        assert mix["evaluations"] > 0
        assert mix["collectives"]["data"] == mix["evaluations"]
        assert mix["collectives"]["chains"] == 1


def test_no_collective_under_a_transform(ranks):
    """``all_reduce_block_sum`` refuses to run under ``torch.func.grad``
    (where it would leave out the other shards' gradients)."""
    for r in ranks:
        for case in r["densities"].values():
            assert case["refused"] is not None
            assert "torch.func transform" in case["refused"]


def test_plan_names_its_backend(ranks):
    got = ranks[0]["densities"][("gauss_unknown", 2)]["repr"]
    assert got == ("ShardedRun(chains=2 x data=2, shard_sites=['y'], "
                   "backend=gloo)")


def test_chains_only_draw_parity(ranks):
    """The 4 x 1 chains mesh draws what the unsharded run draws (each rank
    the fleet's randomness, its own rows), within 1e-4."""
    for r in ranks:
        c = r["chains_only"]
        assert c["plan"] == (4, 1)
        for k, v in c["base"]["draws"].items():
            assert v.shape == (8, 6) + v.shape[2:]
            np.testing.assert_allclose(c["mesh"]["draws"][k], v, atol=1e-4,
                                       rtol=1e-4)


def test_every_rank_returns_the_whole_fleet(ranks):
    """Each rank's ``Chain`` holds all 8 chains, the same on every rank."""
    first = ranks[0]["chains_only"]["mesh"]
    for r in ranks[1:]:
        _same(r["chains_only"]["mesh"], first)
        _same(r["mixing"]["chain"], ranks[0]["mixing"]["chain"])
    assert first["draws"]["m"].shape[0] == 8


def test_rwmh_on_a_data_mesh_matches_unsharded(ranks):
    """RWMH on the 2 x 2 chains x data mesh (its density batches itself)
    against the unsharded run, within 1e-4."""
    for r in ranks:
        c = r["chains_only"]
        for k, v in c["rwmh_base"]["draws"].items():
            np.testing.assert_allclose(c["rwmh_mesh"]["draws"][k], v,
                                       atol=1e-4, rtol=1e-4)


def test_sharded_runs_are_deterministic(ranks):
    """Two identical 2 x 2 runs are bit-exact, and the second builds and
    traces nothing."""
    for r in ranks:
        rr = r["reruns"]
        _same(rr["a"], rr["b"])
        misses, retraces, hits = rr["second"]
        assert misses == 0 and retraces == 0 and hits > 0


def test_program_key_sharding_component(ranks):
    """Mesh programs key on the plan's fingerprint, single-device ones on
    (): the transition of each, and the 2 x 2 mesh's sharded density."""
    for r in ranks:
        rr = r["reruns"]
        keys = set(rr["keys"])
        fp22, fp41 = rr["fingerprints"]["2x2"], rr["fingerprints"]["4x1"]
        assert ("transition", ()) in keys
        assert ("transition", fp41) in keys
        assert ("transition", fp22) in keys
        assert ("density", fp22) in keys
        assert ("density", ()) in keys
        assert fp22 == ("mesh", (2, 2), ("chains", "data"), ("y",))


def test_data_sharded_chains_run_and_mix(ranks):
    """chains x data end to end: adaptive HMC on the 2 x 2 mesh gives
    finite draws whose posterior mean of m is within 5 standard errors of
    the data mean (tests/test_sharded_chains.py's gate)."""
    mix = ranks[0]["mixing"]
    ch, y = mix["chain"], mix["y"]
    assert np.isfinite(ch["stats"]["logp"]).all()
    assert ch["draws"]["m"].shape == (8, 100)
    assert abs(ch["draws"]["m"].mean() - y.mean()) < \
        5 * y.std() / np.sqrt(len(y))
    assert mix["misses"] >= 1


def test_data_groups_hold_identical_states(ranks):
    """The two ranks of each data group run the same chains on halves of
    the data: their chain blocks end bit for bit equal (each rank's fleet
    is its chain group's blocks, so equal fleets across a data group)."""
    for a, b in DATA_GROUPS:
        _same(ranks[a]["mixing"]["chain"], ranks[b]["mixing"]["chain"])
        _same(ranks[a]["reruns"]["a"], ranks[b]["reruns"]["a"])


def test_sharded_resume_bit_exact(ranks):
    """A mesh run preempted and resumed equals the same mesh run
    uninterrupted, bit for bit."""
    for r in ranks:
        res = r["resume"]
        preempted, completed = res["part"]
        assert preempted and completed == 20   # the second poll
        assert res["resumed_from"] == (20, False)
        _same(res["full"], res["res"])


def test_snapshot_is_placement_agnostic(ranks):
    """An unsharded run's snapshot resumed on the 4 x 1 mesh equals the
    unsharded run (within 1e-4: the chain blocks' vmap against the
    fleet's)."""
    for r in ranks:
        res = r["resume"]
        assert res["moved_from"] == 30
        for k, v in res["alone"]["draws"].items():
            np.testing.assert_allclose(res["moved"]["draws"][k], v,
                                       atol=1e-4, rtol=1e-4)


def test_mesh_nan_fallback(ranks):
    """A NaN in the state at transition 15 of a chains-only mesh run: the
    fleet's summary flags it on every rank, the segment is rerun on the
    reference twin, and the draws are the unsharded run's (within 1e-4)."""
    for r in ranks:
        res = r["resume"]
        mesh_h, alone_h = res["nan_health"]
        assert mesh_h == alone_h and mesh_h[0] == 1 and mesh_h[1] == 8
        assert np.isfinite(res["nan_mesh"]["stats"]["logp"]).all()
        for k, v in res["nan_alone"]["draws"].items():
            np.testing.assert_allclose(res["nan_mesh"]["draws"][k], v,
                                       atol=1e-4, rtol=1e-4)


def test_segmented_mesh_rejects_data_sharding(ranks):
    for r in ranks:
        assert r["errors"]["segments"] == (
            "the segmented driver shards chains only; data-parallel plans "
            "(data shards > 1) require the single-scan run_chains path "
            "(checkpointing disabled)")


def test_num_chains_must_divide_chain_axis(ranks):
    """``repro``'s message, word for word."""
    with pytest.raises(ValueError) as exc:
        JShardedRun(FakeMesh((4, 1), ("chains", "data"))).validate_chains(6)
    for r in ranks:
        assert r["errors"]["indivisible"] == str(exc.value)


def test_constrain_redistributes_a_dtensor(ranks):
    """Under rules with a mesh, ``constrain`` lays a DTensor out over its
    device mesh (an axis that does not divide the dim is dropped) and
    returns a plain tensor as it is."""
    for r in ranks:
        d = r["dtensor"]
        assert d["data"]["placements"] == ("R", "S(0)")
        assert d["data"]["local"] == (4, 2)
        assert d["both"]["placements"] == ("S(0)", "S(0)")
        assert d["both"]["local"] == (2, 2)
        assert d["indivisible"]["placements"] == ("R", "R")
        for case, rows in (("data", 8), ("both", 8), ("indivisible", 3)):
            assert d[case]["plain_kept"]
            np.testing.assert_array_equal(
                d[case]["full"], np.arange(rows * 2.0).reshape(rows, 2))


def test_nuts_on_a_data_mesh(ranks):
    """NUTS on two 1 x 2 meshes at once (ranks {0, 1} and {2, 3}): finite
    draws, the two ranks of each mesh identical, with as many data-axis
    collectives on each (every leaf iteration's, in lockstep)."""
    for a, b in DATA_GROUPS:
        na, nb = ranks[a]["nuts"], ranks[b]["nuts"]
        assert na["pair"] == [a, b] and na["shape"] == (1, 2)
        assert np.isfinite(na["chain"]["stats"]["logp"]).all()
        assert na["chain"]["draws"]["m"].shape == (2, 10)
        _same(na["chain"], nb["chain"])
        assert na["collectives"] == nb["collectives"] > 0
    _same(ranks[0]["nuts"]["chain"], ranks[2]["nuts"]["chain"])


# ---------------------------------------------------------------------------
# expert parallelism (tests/test_moe_ep.py's contracts) on 2-rank meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh,collectives", [
    ("1x2", {"model": 1, "model+data": 1}),
    ("2x1", {"data": 1, "model+data": 1})])
def test_moe_ep_matches_moe_ffn_on_two_ranks(ranks, mesh, collectives):
    """Every rank returns the whole output and the whole gradient, equal
    to ``moe_ffn``'s at 1e-6 (each gradient at 1e-6 of its leaf's largest
    entry, as its sums run over the ranks in another order): forward, one
    all-reduce over the expert axis (none where it has one rank) and one
    all-gather over the batch axis (none where it has one rank); backward,
    one all-reduce of the packed gradients over both axes. The two pairs
    of ranks, each on its own mesh, agree bit for bit."""
    params, x, _ = _torch_dist.moe_case()
    factor = 1.25 if mesh == "1x2" else (_torch_dist.MOE["n_experts"]
                                         / _torch_dist.MOE["top_k"])
    assert (_torch_dist.moe_drops(params, x, factor) > 0) == (mesh == "1x2")
    want_y, _ = moe_ffn_reference(factor)
    for r in ranks:
        case = r["moe_ep"][mesh]
        assert case["collectives"] == collectives
        np.testing.assert_allclose(case["y"], want_y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(case["y_ep"], case["y"], rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(case["grads_ep"], case["grads"]):
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    for r in ranks[1:]:
        for a, b in zip(r["moe_ep"][mesh]["grads_ep"],
                        ranks[0]["moe_ep"][mesh]["grads_ep"]):
            np.testing.assert_array_equal(a, b)


def test_moe_ep_deepseek_smoke_forward(ranks):
    for r in ranks:
        d = r["moe_ep"]["deepseek"]
        assert d["ep"].shape == (2, 16, 256)
        assert np.isfinite(d["ep"]).all()
        np.testing.assert_allclose(d["ep"], d["gspmd"], rtol=1e-5,
                                   atol=1e-5)
        assert d["collectives"] == {"model": d["moe_layers"]}
