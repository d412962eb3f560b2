"""PyTorch port: the samplers beyond static HMC (NUTS, RWMH, MAP, ADVI,
SGLD), the minibatch estimator and the untyped HMC path.

The JAX package is the reference draw for draw where a path is
deterministic given its draws: NUTS's two helpers (``_leaf_to_ckpt`` over
every leaf counter below 2^10; ``_is_turning`` on fixed NumPy states);
one lockstep NUTS tree for several chains against ``repro``'s
``_build_step`` run eagerly one chain at a time, both fed the same
momentum and uniforms; both packages' ``run_untyped`` (HMC and RWMH: the
same NumPy stream, seeded as ``repro`` seeds it from its key); and MAP's
Adam path. The rest holds the port against itself or against a known
posterior: ``tests/test_infer.py`` already pays for the JAX package's own
sampler compiles.

Moment bounds are stated in Monte-Carlo standard errors (se) from the
chains' own ESS, or from the posterior sd and a conservative ESS where a
run is too short to estimate one. Draw counts are cut from
``tests/test_infer.py``'s to keep the CPU suite's time, and the bounds
widened with them: each stays at >= 4.5 se.
"""
import dataclasses
import sys
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.infer as tinfer
import repro
from repro import infer as jinfer
from repro.dists import HalfNormal as JHalfNormal
from repro.dists import Normal as JNormal
from repro.infer import nuts as jnuts
from repro_torch import model, observe, sample
from repro_torch.core import reject_if
from repro_torch.dists import HalfNormal, Normal
from repro_torch.infer import (ADVI, HMC, MAP, NUTS, RWMH, SGLD,
                               effective_sample_size, make_sgld_step,
                               make_subsampled_sgld_step)
from repro_torch.convert import state_from_reference
from repro_torch.infer import nuts as tnuts
from repro_torch.infer.hmc import value_and_grad
from repro_torch.models import paper_suite as tsuite
from repro_torch.sharding import Minibatch, make_minibatch_logdensity
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


def _se_bound(x, n_se):
    """``n_se`` Monte-Carlo standard errors of the mean of ``x`` (chains,
    draws), from the chains' ESS."""
    return n_se * float(np.std(x)) / np.sqrt(effective_sample_size(x))


@pytest.fixture(scope="module")
def gauss_model():
    np.random.seed(0)
    data = np.random.normal(2.0, 1.0, size=200).astype(np.float32)

    @model
    def gauss(y):
        mu = sample("mu", Normal(0.0, 10.0))
        s = sample("s", HalfNormal(2.0))
        observe("y", Normal(mu, s), y)

    return gauss(torch.tensor(data)), data


@pytest.fixture(scope="module")
def gauss_pair(gauss_model):
    """``gauss_model`` in both packages, and one trace for both near the
    posterior (mu 2.3, s 1.2: a start far in the prior's tail sends the
    fixed-step trajectories to NaN, which ``repro``'s ``run_untyped``
    accepts through ``min(0.0, nan)`` and the port rejects)."""
    tm, data = gauss_model

    @repro.model
    def jgauss(y):
        mu = repro.sample("mu", JNormal(0.0, 10.0))
        s = repro.sample("s", JHalfNormal(2.0))
        repro.observe("y", JNormal(mu, s), y)

    jm = jgauss(jnp.asarray(data))
    jtvi = jm.typed_varinfo(jax.random.PRNGKey(0)).replace_flat(
        jnp.asarray([2.3, 1.2]))
    ttvi = state_from_reference(
        tm.typed_varinfo(torch.Generator().manual_seed(0)),
        np.array(jtvi.flat()), _signature(jtvi))
    return tm, jm, ttvi, jtvi


def _signature(jtvi):
    return tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                 for s in jtvi.layout.sites)


def _run_seed(key) -> int:
    """The integer ``repro``'s ``run_untyped`` seeds NumPy with."""
    return int(np.asarray(jax.random.key_data(jax.random.split(key)[1]))[-1])


def _corr():
    """x ~ N(0, 1), y | x ~ N(x, 0.5) (``tests/test_infer.py``'s), in
    both packages."""
    @model
    def corr():
        x = sample("x", Normal(0.0, 1.0))
        sample("y", Normal(x, 0.5))

    @repro.model
    def jcorr():
        x = repro.sample("x", JNormal(0.0, 1.0))
        repro.sample("y", JNormal(x, 0.5))

    return corr(), jcorr()


# ---- the package's names ---------------------------------------------------
def test_infer_exports_the_reference_names():
    import repro.infer as jinfer
    missing = set(jinfer.__all__) - set(tinfer.__all__)
    # the fault-tolerant driver (ROADMAP.md Queue 1 item 7) is ported too
    assert missing == set()
    for name in tinfer.__all__:
        assert hasattr(tinfer, name)


# ---- NUTS helpers against the JAX package -----------------------------------
MAX_DEPTH = 10


def _turning_states():
    rng = np.random.default_rng(3)
    states = rng.normal(size=(8, 4, 5)).astype(np.float32)
    # states that face each other, and ones that run apart
    states[0, 3] = states[0, 2] + 1.0
    states[0, 1], states[0, 0] = -states[0, 3], states[0, 2]
    return states


@pytest.fixture(scope="module")
def nuts_reference():
    """Both helpers of ``repro.infer.nuts`` in one jitted program: the
    checkpoint range of every leaf counter below 2^10, and the u-turn test
    on fixed states (one a row)."""
    n = np.arange(1 << MAX_DEPTH, dtype=np.int32)
    states = _turning_states()
    ckpt, turning = jax.jit(lambda n, s: (
        jax.vmap(lambda i: jnuts._leaf_to_ckpt(i, MAX_DEPTH))(n),
        jax.vmap(jnuts._is_turning)(s[:, 0], s[:, 1], s[:, 2], s[:, 3])))(
        jnp.asarray(n), jnp.asarray(states))
    return n, states, [np.asarray(c) for c in ckpt], np.asarray(turning)


def test_leaf_to_ckpt_matches_the_reference_for_every_counter(
        nuts_reference):
    n, _, want, _ = nuts_reference
    got = np.array([tnuts._leaf_to_ckpt(int(i), MAX_DEPTH) for i in n])
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


def test_is_turning_matches_the_reference(nuts_reference):
    _, states, _, want = nuts_reference
    got_one = np.array([bool(tnuts._is_turning(*map(torch.tensor, s)))
                        for s in states])
    # the chain batch: one row a state
    got = tnuts._is_turning(*(torch.tensor(states[:, k]) for k in range(4)))
    np.testing.assert_array_equal(got_one, want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


# ---- NUTS, one lockstep tree against the JAX package -----------------------
def _nuts_levels(events, draws, max_depth):
    """The port's draws of one tree by role: the momentum, then for each
    doubling the direction uniform, the leaf uniforms and the merge
    uniform. ``events`` interleaves "draw" with the loop tests' results:
    one test before each doubling, one before each leaf after the first."""
    ev, it = list(events), iter(draws)

    def draw():
        assert ev.pop(0) == "draw"
        return next(it).numpy()

    p0, levels = draw(), []
    for level in range(max_depth):
        if not ev.pop(0):
            break
        direction, leaves = draw(), [draw()]
        while len(leaves) < 1 << level and ev[0] != "draw":
            if not ev.pop(0):
                break
            leaves.append(draw())
        levels.append((direction, leaves, draw()))
    assert not ev
    return p0, levels


def test_nuts_lockstep_tree_matches_the_reference_chain_by_chain(
        monkeypatch):
    """One transition of 4 chains in lockstep against ``repro``'s
    ``_build_step`` for each chain alone, run eagerly (``disable_jit``, its
    density jitted) with its draws replaced by the port's: the momentum,
    each doubling's direction (``bernoulli`` is ``uniform < 0.5``), each
    leaf's uniform and the merge's. On this start the chains stop at
    depths 3 to 5, two of them inside a subtree, so the frozen rows,
    the checkpoint slots and the early leaf-loop exit are all held."""
    max_depth, eps = 6, 0.1
    tm, jm = _corr()
    tl = tm.typed_varinfo(torch.Generator().manual_seed(0)).link()
    jl = jm.typed_varinfo(jax.random.PRNGKey(0)).link()
    q0 = np.random.default_rng(5).normal(size=(4, 2)).astype(np.float32)
    ld = value_and_grad(tm.make_logdensity_fn(tl))
    step = NUTS(max_depth=max_depth)._build_step(ld, 2)
    logp0, grad0 = ld(torch.tensor(q0))
    events, draws = [], []

    def recorded(real):
        def f(*a, **k):
            x = real(*a, **k)
            events.append("draw")
            draws.append(x.clone())
            return x
        return f

    real_sync = tnuts._sync_any
    with monkeypatch.context() as mp:
        mp.setattr(torch, "rand", recorded(torch.rand))
        mp.setattr(torch, "randn", recorded(torch.randn))
        mp.setattr(tnuts, "_sync_any",
                   lambda m: events.append(real_sync(m)) or events[-1])
        got = step(torch.tensor(q0), logp0, grad0, eps,
                   torch.Generator().manual_seed(3))
    p0, levels = _nuts_levels(events, draws, max_depth)

    jld = jax.jit(jax.value_and_grad(jm.make_logdensity_fn(jl)))
    jstep = jnuts.NUTS(max_depth=max_depth)._build_step(
        lambda q: _jitted(jld, q), 2)
    leaves_seen = []
    for c in range(4):
        at = {"level": -1, "leaves": []}

        def bernoulli(key, p=0.5, shape=None):
            at["level"] += 1
            at["leaves"].append(0)
            return jnp.asarray(levels[at["level"]][0][c] < 0.5)

        def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
            _, leaves, merge = levels[at["level"]]
            if sys._getframe(1).f_code.co_name == "leaf_body":
                at["leaves"][-1] += 1
                return jnp.asarray(leaves[at["leaves"][-1] - 1][c])
            return jnp.asarray(merge[c])

        with monkeypatch.context() as mp, jax.disable_jit():
            mp.setattr(jax.random, "normal",
                       lambda key, shape=(), dtype=None: jnp.asarray(p0[c]))
            mp.setattr(jax.random, "bernoulli", bernoulli)
            mp.setattr(jax.random, "uniform", uniform)
            lp, g = _jitted(jld, jnp.asarray(q0[c]))
            want = jstep(jnp.asarray(q0[c]), lp, g, jnp.asarray(eps),
                         jax.random.PRNGKey(0))
        leaves_seen.append(at["leaves"])
        for a, b in zip(got[:4], want[:4]):  # q, logp, grad, accept_prob
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
        assert int(got[4][c]) == int(want[4]) == len(at["leaves"])
        assert bool(got[5][c]) == bool(want[5])
    # lockstep: each doubling runs the leaves of its longest live chain
    for level, (_, leaves, _) in enumerate(levels):
        assert len(leaves) == max(seen[level] for seen in leaves_seen
                                  if len(seen) > level)
    depths = [len(seen) for seen in leaves_seen]
    assert len(set(depths)) > 1
    assert sum(seen[-1] < 1 << (len(seen) - 1) for seen in leaves_seen) >= 2


def _jitted(fn, q):
    """``fn`` (a jitted JAX function) compiled even under ``disable_jit``."""
    with jax.disable_jit(False):
        return fn(q)


# ---- NUTS, port against port ------------------------------------------------
def test_nuts_fused_and_autodiff_leaves_give_the_same_draws(monkeypatch):
    """gaussian_10k (cut to 16-D) compiles to a separable spec: its leaves
    are one ``potential_value_and_grad`` call for all chains, once per
    lockstep leaf iteration (and once at chain init); the autodiff leaves
    give the same draws for the same seed. Step-size adaptation is off:
    dual averaging multiplies the acceptance statistic's last-bit
    differences by ~20 sqrt(t) into the step size, and the draws part at
    1e-4 (on this model the two integrators' draws are otherwise equal)."""
    pm = tsuite.build("gaussian_10k", device="cpu", dim=16)
    calls = []
    real = tnuts.potential_value_and_grad
    monkeypatch.setattr(tnuts, "potential_value_and_grad",
                        lambda spec, q: calls.append(q.shape) or real(spec, q))
    tnuts.reset_tree_counts()
    fused = tinfer.run_chains(4, pm.model,
                              NUTS(step_size=0.5, max_depth=6,
                                   adapt_step_size=False),
                              20, num_warmup=10, num_chains=3, device="cpu")
    counts = dict(tnuts.TREE_COUNTS)
    assert counts["trees"] == 30 and counts["draws"] == 20  # + 10 warmup
    assert 20 <= counts["draw_leaf_iterations"] < counts["leaf_iterations"]
    assert len(calls) == counts["leaf_iterations"] + 1
    assert all(s == (3, 16) for s in calls)  # all chains in one call
    assert counts["host_syncs"] >= counts["trees"]
    ref = tinfer.run_chains(4, pm.model,
                            NUTS(step_size=0.5, max_depth=6,
                                 adapt_step_size=False,
                                 leapfrog="reference"),
                            20, num_warmup=10, num_chains=3, device="cpu")
    np.testing.assert_allclose(fused["x"], ref["x"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fused.stats["logp"], ref.stats["logp"],
                               rtol=1e-5)
    np.testing.assert_array_equal(fused.stats["tree_depth"],
                                  ref.stats["tree_depth"])
    assert fused.stats["tree_depth"].shape == (3, 20)
    assert len(calls) == counts["leaf_iterations"] + 1  # reference: none
    with pytest.raises(ValueError, match="separable"):
        tinfer.run_chains(0, tsuite.build("logreg", device="cpu", n=8,
                                          dim=2).model,
                          NUTS(leapfrog="fused"), 1, device="cpu")


def test_nuts_correlated_gaussian_moments():
    """x ~ N(0, 1), y | x ~ N(x, 0.5) (``tests/test_infer.py``'s): 4
    chains of 200 draws after 100 of warmup (the reference runs one chain
    of 2,000), the per-site evaluator for speed."""
    ch = NUTS(step_size=0.2, max_depth=5, backend="reference").run(
        6, _corr()[0], 200, num_warmup=100, num_chains=4, device="cpu")
    x, y = ch["x"], ch["y"]
    ess = min(effective_sample_size(x), effective_sample_size(y))
    assert ess > 100  # 800 draws; NUTS mixes these at ESS ~ draws / 3
    assert abs(x.mean()) < _se_bound(x, 4.5)
    # se of a sample sd ~ sd / sqrt(2 ESS)
    assert abs(x.std() - 1.0) < 4.5 / np.sqrt(2.0 * ess)
    assert abs(y.std() - np.sqrt(1.25)) < 4.5 * np.sqrt(1.25 / (2.0 * ess))
    # correlation: se ~ (1 - rho^2) / sqrt(ESS)
    rho = 1.0 / np.sqrt(1.25)
    corr_hat = np.corrcoef(x.ravel(), y.ravel())[0, 1]
    assert abs(corr_hat - rho) < 4.5 * (1.0 - rho ** 2) / np.sqrt(ess)
    assert ch.stats["tree_depth"].mean() >= 1.0
    assert 0.5 < ch.stats["accept_prob"].mean() <= 1.0


# ---- RWMH ---------------------------------------------------------------------
def test_rwmh_untyped_rejects_early_and_typed_runs():
    rng = np.random.default_rng(2)
    y = torch.tensor(rng.normal(0.0, 1.0, size=5).astype(np.float32))

    @model
    def capped(y):
        mu = sample("mu", Normal(0.0, 1.0))
        reject_if(mu > 0.5)
        observe("y", Normal(mu, 1.0), y)

    m = capped(y)
    tvi = m.typed_varinfo(torch.Generator().manual_seed(0))
    start = float(tvi["mu"])
    ch = RWMH(0.5).run_untyped(1, m, 300, init_varinfo=tvi, device="cpu")
    n_early = int(ch.stats["n_early_rejected"])
    # every proposal above 0.5 aborts the replay: about P(mu' > 0.5) of
    # the 300 proposals, and no accepted draw lies there (but the start)
    assert 20 < n_early < 200
    mu = ch["mu"].ravel()
    assert (mu[mu != start] <= 0.5).all()
    assert ch.num_chains == 1 and ch.num_samples == 300
    assert set(ch.stats) == {"logp", "accept_prob", "n_early_rejected"}
    # the typed path masks the same site to -inf instead of aborting
    typed = RWMH(0.5).run(1, m, 100, num_chains=2, device="cpu")
    logp = typed.stats["logp"]
    assert typed.num_chains == 2 and np.isfinite(logp[:, -1]).all()
    assert (typed["mu"][np.isfinite(logp)] <= 0.5).all()
    assert typed.stats["accept_prob"].dtype == np.float32


def test_rwmh_untyped_matches_the_reference_draw_for_draw():
    """Both packages' eager RWMH on the capped model from one trace, the
    port seeded with the integer ``repro`` derives from its key: the same
    proposals, early rejections and accepts."""
    y = np.random.default_rng(2).normal(0.0, 1.0, size=5).astype(np.float32)

    @model
    def capped(y):
        mu = sample("mu", Normal(0.0, 1.0))
        reject_if(mu > 0.5)
        observe("y", Normal(mu, 1.0), y)

    @repro.model
    def jcapped(y):
        mu = repro.sample("mu", JNormal(0.0, 1.0))
        repro.reject_if(mu > 0.5)
        repro.observe("y", JNormal(mu, 1.0), y)

    jm = jcapped(jnp.asarray(y))
    jtvi = jm.typed_varinfo(jax.random.PRNGKey(1))
    tvi = state_from_reference(
        capped(torch.tensor(y)).typed_varinfo(torch.Generator()),
        np.array(jtvi.flat()), _signature(jtvi))
    key = jax.random.PRNGKey(8)
    want = jinfer.RWMH(0.5).run_untyped(key, jm, 40, init_varinfo=jtvi)
    got = RWMH(0.5).run_untyped(_run_seed(key), capped(torch.tensor(y)), 40,
                                init_varinfo=tvi, device="cpu")
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.stats["logp"], want.stats["logp"],
                               rtol=1e-5)
    np.testing.assert_array_equal(got.stats["accept_prob"],
                                  want.stats["accept_prob"])
    n_early = int(got.stats["n_early_rejected"])
    assert n_early == int(want.stats["n_early_rejected"]) > 0
    assert 0 < got.stats["accept_prob"].sum() < 40 - n_early


# ---- dual averaging with the iteration on the device ---------------------
def test_dual_averaging_with_a_float32_t_matches_the_reference():
    """``t`` as a float32 tensor, as the port's warm program carries it and
    as ``repro`` feeds it (``jnp.arange(num_warmup, float32)``): 100
    updates against ``repro``'s ``DualAveraging`` run in one ``jax.jit``
    (a ``lax.scan``), at rtol 1e-6."""
    from repro.infer import hmc as jhmc
    from repro_torch.infer.hmc import DualAveraging

    accs = np.random.default_rng(3).random(100).astype(np.float32)

    def scan(accs):
        da = jhmc.DualAveraging()

        def body(state, inp):
            t, a = inp
            return da.update(state, a, t), None

        state, _ = jax.lax.scan(body, da.init(jnp.float32(0.05)),
                                (jnp.arange(100, dtype=jnp.float32), accs))
        return state

    want = jax.jit(scan)(jnp.asarray(accs))
    da = DualAveraging()
    state, t = da.init(torch.tensor(0.05)), torch.zeros(())
    for a in accs:
        state = da.update(state, torch.tensor(a), t)
        t = t + 1.0
    for got, w in zip(state, want):
        np.testing.assert_allclose(float(got), float(w), rtol=1e-6)


# ---- MAP and ADVI ---------------------------------------------------------------
def test_map_recovers_the_mode(gauss_model):
    m, data = gauss_model
    est, losses = MAP(num_steps=300).run(13, m, device="cpu")
    assert abs(float(est["mu"]) - data.mean()) < 0.05
    assert abs(float(est["s"]) - data.std()) < 0.05
    assert losses.shape == (300,) and losses[-1] < losses[0]


def test_map_matches_the_reference_step_for_step(gauss_pair):
    """Adam from 0 in both packages over 50 steps: the losses and the
    mode at every step's end agree at 1e-5."""
    tm, jm, ttvi, jtvi = gauss_pair
    want, wlosses = jinfer.MAP(num_steps=50).run(jax.random.PRNGKey(0), jm,
                                                 init_varinfo=jtvi)
    got, losses = MAP(num_steps=50).run(0, tm, init_varinfo=ttvi,
                                        device="cpu")
    np.testing.assert_allclose(losses, wlosses, rtol=1e-5)
    for site in ("mu", "s"):
        np.testing.assert_allclose(float(got[site]), float(want[site]),
                                   rtol=1e-5)
    assert losses[-1] < losses[0] / 2


def test_advi_full_and_minibatch(gauss_model):
    """The full-batch fit recovers the posterior mean (its spread across
    reseeds ~0.02, so 0.1 is ~5 se) and the minibatch fit (``minibatch=``,
    one index set a step) lands near the full one."""
    m, data = gauss_model
    full = ADVI(num_steps=400, lr=0.05).run(9, m, device="cpu")
    post = full.sample(11, 2000)
    assert post["mu"].shape == (2000,)
    assert abs(float(post["mu"].mean()) - data.mean()) < 0.1
    assert abs(float(post["s"].mean()) - data.std()) < 0.1
    assert full.elbo_trace[-1] > full.elbo_trace[0]
    mini = ADVI(num_mc=4, lr=0.05, num_steps=300,
                minibatch=Minibatch(("y",), 32)).run(2, m, device="cpu")
    assert abs(float(mini.mu[0]) - float(full.mu[0])) < 0.1
    assert np.isfinite(mini.elbo_trace).all()
    with pytest.raises(ValueError, match="owns the evaluation context"):
        from repro_torch.core.contexts import DefaultContext
        ADVI(minibatch=Minibatch(("y",), 32)).run(2, m, ctx=DefaultContext(),
                                                   device="cpu")


# ---- the minibatch estimator (tests/test_sharded_chains.py:105-145) -----------
def test_minibatch_unbiased_over_all_draws():
    """E over ALL size-B subsets of the scaled estimator == full density
    (exact enumeration; float32 summation gives ~1e-5 slack)."""
    pm = tsuite.build("gauss_unknown", n=6, device="cpu")
    tvi = pm.model.typed_varinfo(torch.Generator().manual_seed(1)).link()
    q = tvi.flat() + 0.25
    full = float(pm.model.make_logdensity_fn(tvi)(q))
    for bsz in (1, 2, 3):
        est = make_minibatch_logdensity(pm.model, tvi,
                                        Minibatch(("y",), bsz))
        assert est.num_total == 6 and est.scale == 6.0 / bsz
        vals = [float(est.logdensity_at_indices(q, torch.tensor(c)))
                for c in itertools.combinations(range(6), bsz)]
        assert abs(np.mean(vals) - full) < 5e-4 * max(1.0, abs(full)), bsz


def test_minibatch_draws_and_validation():
    pm = tsuite.build("gauss_unknown", n=32, device="cpu")
    tvi = pm.model.typed_varinfo(torch.Generator().manual_seed(1)).link()
    q = tvi.flat()
    est = make_minibatch_logdensity(pm.model, tvi, Minibatch(("y",), 8))
    idx = est.draw_indices(torch.Generator().manual_seed(7))
    assert idx.shape == (8,) and len(set(idx.tolist())) == 8
    np.testing.assert_allclose(
        float(est.logdensity(q, torch.Generator().manual_seed(7))),
        float(est.logdensity_at_indices(q, idx)))
    small = tsuite.build("gauss_unknown", n=8, device="cpu")
    with pytest.raises(ValueError, match="not bound data"):
        make_minibatch_logdensity(small.model, tvi, Minibatch(("nope",), 2))
    with pytest.raises(ValueError, match="exceeds"):
        make_minibatch_logdensity(small.model, tvi, Minibatch(("y",), 9))
    with pytest.raises(ValueError, match="batch_size"):
        Minibatch(("y",), 0)
    with pytest.raises(ValueError, match="at least one"):
        Minibatch((), 2)


# ---- SGLD (tests/test_sharded_chains.py:146) ------------------------------------
def test_subsampled_sgld_moves_toward_posterior():
    """Self-batching SGLD step: runs, is finite, and (at temperature 0,
    i.e. pure preconditioned ascent) increases the full log-joint."""
    rng = np.random.default_rng(0)
    y = rng.normal(2.0, 1.0, size=64).astype(np.float32)

    @model
    def gm(y):
        mu = sample("params", Normal(0.0, 10.0))
        observe("y", Normal(mu, 1.0), y)

    m = gm(torch.tensor(y))
    # pSGLD preconditioning sign-normalises the gradient, so the travel
    # budget is ~step_size per iteration: 300 x 2e-2 >> |0 - ybar|
    sgld = SGLD(step_size=2e-2, temperature=0.0)
    step = make_subsampled_sgld_step(m, Minibatch(("y",), 16), sgld)
    params = torch.zeros(())
    state = sgld.init(params)
    gen = torch.Generator().manual_seed(0)
    lp0 = float(m.logjoint({"params": params}))
    lps = []
    for _ in range(300):
        params, state, lp = step(gen, params, state)
        lps.append(lp)
    assert torch.isfinite(torch.stack(lps)).all()
    assert float(m.logjoint({"params": params})) > lp0
    assert abs(float(params) - y.mean()) < 0.5
    with pytest.raises(TypeError, match="Minibatch"):
        make_subsampled_sgld_step(m, ("y", 16))


def test_sgld_step_on_a_bound_batch_and_the_lm_refusal():
    """``make_sgld_step`` takes its batch as bound data, one cached
    program a structural signature; plain SGLD (no preconditioning) at
    temperature 1 stays near the posterior; the LM refusal is gone: the
    step builds and runs on a Bayesian LM (its attention and SSD
    Functions run under ``torch.func``), as ``repro``'s does."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.program import cache_stats
    from repro_torch.models.bayes_lm import make_lm_model

    rng = np.random.default_rng(1)
    y = torch.tensor(rng.normal(1.0, 1.0, size=256).astype(np.float32))

    @model
    def gm(y):
        mu = sample("params", Normal(0.0, 10.0))
        observe("y", Normal(mu, 1.0), y)

    m = gm(y[:32])
    sgld = SGLD(step_size=1e-3, precondition=False)
    step = make_sgld_step(m, scale=256 / 32, sgld=sgld)
    gen = torch.Generator().manual_seed(3)
    params, state = torch.tensor(1.0), sgld.init(torch.tensor(1.0))
    draws = []
    for t in range(200):
        batch = y[(t % 8) * 32:(t % 8 + 1) * 32]
        misses = cache_stats()["misses"]
        params, state, _ = step(gen, params, state, y=batch)
        assert t == 0 or cache_stats()["misses"] == misses
        draws.append(float(params))
    # the posterior of mu: mean ybar, sd 1/16; 200 correlated draws
    assert abs(np.mean(draws[50:]) - float(y.mean())) < 0.3
    from repro_torch.nn import lm as tlm
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              attn_impl="flash")
    lm_params = tlm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    lm = make_lm_model(cfg)(tokens=toks, labels=toks, params=lm_params)
    sgld0 = SGLD(temperature=0.0)
    _, _, lp = make_sgld_step(lm, 1.0, sgld=sgld0)(
        gen, lm_params, sgld0.init(lm_params), tokens=toks, labels=toks)
    assert torch.isfinite(lp)


# ---- untyped HMC against the JAX package ----------------------------------------
def test_untyped_hmc_matches_the_reference_draw_for_draw(gauss_pair):
    """Both packages' eager HMC from one trace over 10 draws, the port
    seeded with the integer ``repro`` derives from its key: the same
    momenta and accept draws give the same draws, densities and
    acceptance probabilities."""
    tm, jm, ttvi, jtvi = gauss_pair
    key = jax.random.PRNGKey(4)
    kw = dict(step_size=0.05, n_leapfrog=4)
    want = jinfer.HMC(**kw).run_untyped(key, jm, 10, init_varinfo=jtvi)
    got = HMC(**kw).run_untyped(_run_seed(key), tm, 10, init_varinfo=ttvi,
                                device="cpu")
    for site in ("mu", "s"):
        np.testing.assert_allclose(got[site], want[site], rtol=1e-5)
    np.testing.assert_allclose(got.stats["logp"], want.stats["logp"],
                               rtol=1e-5)
    # exp(h0 - h1) of two energies near |logp| ~ 300, each held at rtol
    # 1e-5: float32 sums differ in their last bits (~3e-5 here)
    np.testing.assert_allclose(
        got.stats["accept_prob"], want.stats["accept_prob"], rtol=0,
        atol=1e-5 * float(np.abs(want.stats["logp"]).max()))
    moved = np.diff(got["mu"][0]) != 0
    assert moved.any() and not moved.all()


# ---- untyped against typed (tests/test_infer.py:138-160) ------------------------
def test_untyped_and_typed_hmc_agree_by_moments():
    np.random.seed(1)
    data = np.random.normal(0.5, 1.0, size=50).astype(np.float32)

    @model
    def g(y):
        mu = sample("mu", Normal(0.0, 3.0))
        observe("y", Normal(mu, 1.0), y)

    m = g(torch.tensor(data))
    tvi = m.typed_varinfo(torch.Generator().manual_seed(0))
    hmc = HMC(step_size=0.05, n_leapfrog=4)
    # typed: 4 chains of 150 draws from the same start (no jitter)
    ch_t = tinfer.run_chains(2, m, hmc, 150, num_chains=4, init_varinfo=tvi,
                             init_jitter=0.0, device="cpu")
    ch_u = hmc.run_untyped(2, m, 600, init_varinfo=tvi, device="cpu")
    assert ch_u.num_chains == 1 and ch_u.num_samples == 600
    assert set(ch_u.stats) == {"logp", "accept_prob"}
    # the burn-in from the prior draw: the first 20 draws of each are left
    t, u = ch_t["mu"][:, 20:], ch_u["mu"][:, 20:]
    se = np.hypot(_se_bound(t, 1.0), _se_bound(u, 1.0))
    assert abs(t.mean() - u.mean()) < 4.5 * se
    # sd of the posterior ~ 1/sqrt(50); se of a sample sd ~ sd/sqrt(2 ESS)
    ess = min(effective_sample_size(t), effective_sample_size(u))
    assert abs(t.std() - u.std()) < 4.5 * np.sqrt(2.0) * t.std() \
        / np.sqrt(2.0 * ess)
