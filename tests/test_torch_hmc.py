"""PyTorch port: HMC, chains and diagnostics against the JAX package.

JAX's threefry and torch's Philox never give the same draws, so
trajectories are compared by injecting the same NumPy momentum into both
packages' ``_leapfrog``; the NumPy diagnostics must agree exactly; whole
chains are checked for shape, independence and reproducibility.
Trajectory tolerance: rtol 1e-5 with atol 1e-5 * max|x| per quantity
(float32, four gradient evaluations in a different summation order).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.infer import chains as jchains
from repro.infer import hmc as jhmc
from repro.models import paper_suite as jsuite
from repro_torch.convert import layout_signature, state_from_reference
from repro_torch.infer import (HMC, DualAveraging, effective_sample_size,
                               run_chains, split_rhat)
from repro_torch.infer.hmc import (_leapfrog, hmc_transition, make_chain_fn,
                                   value_and_grad)
from repro_torch.models import paper_suite as tsuite
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


SMALL = dict(n=256, dim=8)


def _close_scaled(got, want):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def logreg_pair():
    jm = jsuite.build("logreg", **SMALL)
    tm = tsuite.build("logreg", device="cpu", **SMALL)
    jlinked = jm.model.typed_varinfo(jax.random.PRNGKey(0)).link()
    tlinked = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    return jm, tm, jlinked, tlinked


@pytest.mark.parametrize("metric", ["unit", "diag"])
def test_leapfrog_trajectories_match_jax(logreg_pair, metric):
    jm, tm, jlinked, tlinked = logreg_pair
    rng = np.random.default_rng(0)
    dim = jlinked.num_flat
    q0 = (np.asarray(jlinked.flat())[None]
          + 0.2 * rng.normal(size=(3, dim))).astype(np.float32)
    p0 = rng.normal(size=(3, dim)).astype(np.float32)
    step, n_steps = 0.01, 4
    inv_mass = (None if metric == "unit"
                else rng.uniform(0.5, 2.0, size=dim).astype(np.float32))

    jldg = jax.jit(jax.value_and_grad(jm.model.make_logdensity_fn(jlinked)))
    sig = tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                for s in jlinked.layout.sites)
    tlinked = state_from_reference(tlinked, q0[0], sig)
    assert layout_signature(tlinked) == sig
    tldg = value_and_grad(tm.model.make_logdensity_fn(tlinked))
    qt = torch.tensor(q0)
    _, g0 = tldg(qt)
    got = _leapfrog(tldg, qt, torch.tensor(p0), g0, step, n_steps,
                    inv_mass=None if inv_mass is None
                    else torch.tensor(inv_mass))
    for c in range(3):
        _, jg0 = jldg(jnp.asarray(q0[c]))
        want = jhmc._leapfrog(jldg, jnp.asarray(q0[c]), jnp.asarray(p0[c]),
                              jg0, step, n_steps,
                              inv_mass=None if inv_mass is None
                              else jnp.asarray(inv_mass))
        for g, w in zip(got, want):  # q, p, logp, grad
            _close_scaled(g[c].numpy(), w)


DRAW_SHAPES = [(1, 3), (1, 50), (4, 200), (3, 7)]


@pytest.mark.parametrize("shape", DRAW_SHAPES, ids=str)
def test_diagnostics_equal_the_reference_exactly(shape):
    rng = np.random.default_rng(sum(shape))
    x = np.cumsum(rng.normal(size=shape), axis=1)  # autocorrelated draws
    # fewer than 4 draws per chain: both packages warn and return nan
    warns = (pytest.warns(RuntimeWarning) if shape[1] < 4
             else contextlib.nullcontext())
    with warns:
        got = (effective_sample_size(x), split_rhat(x))
        want = (jchains.effective_sample_size(x), jchains.split_rhat(x))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dual_averaging_matches_jax():
    accs = np.random.default_rng(1).random(12).astype(np.float32)
    tda, jda = DualAveraging(), jhmc.DualAveraging()
    ts, js = tda.init(torch.tensor(0.05)), jda.init(0.05)
    for t, a in enumerate(accs):
        ts = tda.update(ts, torch.tensor(a), float(t))
        js = jda.update(js, jnp.asarray(a), jnp.float32(t))
    for got, want in zip(ts, js):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_hmc_transition_keeps_rejected_chains(logreg_pair):
    _, tm, _, tlinked = logreg_pair
    ldg = value_and_grad(tm.model.make_logdensity_fn(tlinked))
    q = tlinked.flat()[None] + torch.linspace(-1, 1, 6)[:, None]
    logp, grad = ldg(q)
    gen = torch.Generator().manual_seed(5)
    # a huge step on half the chains forces rejections there
    eps = torch.tensor([0.01, 0.01, 0.01, 5.0, 5.0, 5.0])
    q1, logp1, grad1, acc, accepted, div = hmc_transition(
        ldg, q, logp, grad, eps, gen, 4)
    assert q1.shape == q.shape and acc.shape == logp1.shape == (6,)
    assert not accepted[3:].any() and div[3:].all()
    torch.testing.assert_close(q1[3:], q[3:], rtol=0, atol=0)
    torch.testing.assert_close(logp1[3:], logp[3:], rtol=0, atol=0)
    moved = accepted[:3]
    assert bool(moved.any())
    assert bool((q1[:3][moved] != q[:3][moved]).any())
    assert bool(((acc >= 0) & (acc <= 1)).all())


def test_run_chains_shapes_independence_and_reproducibility():
    tm = tsuite.build("logreg", device="cpu", **SMALL)
    kern = HMC(step_size=0.02, n_leapfrog=4)
    a = run_chains(0, tm.model, kern, 30, num_chains=4, device="cpu")
    b = run_chains(0, tm.model, kern, 30, num_chains=4, device="cpu")
    c = run_chains(1, tm.model, kern, 30, num_chains=4, device="cpu")
    assert a["w"].shape == (4, 30, 8) and a["b"].shape == (4, 30)
    for k in ("logp", "accept_prob", "diverging"):
        assert a.stats[k].shape == (4, 30)
    assert np.isfinite(a.stats["logp"]).all()
    assert ((a.stats["accept_prob"] >= 0)
            & (a.stats["accept_prob"] <= 1)).all()
    assert a.stats["accept_prob"].mean() > 0.3
    np.testing.assert_array_equal(a["w"], b["w"])      # same seed
    assert not np.array_equal(a["w"], c["w"])          # other seed
    for i in range(4):                                 # chains differ
        for j in range(i):
            assert not np.array_equal(a["w"][i], a["w"][j])
    assert "rhat" in a.summary()


def test_hmc_run_and_step_size_adaptation():
    tm = tsuite.build("naive_bayes", device="cpu", n=64, n_classes=3, dim=4)
    one = HMC(step_size=0.01).run(0, tm.model, 10, device="cpu")
    assert one["mu"].shape == (1, 10, 3, 4)
    diag = HMC(step_size=0.01, inv_mass=np.full(12, 0.5, np.float32))
    assert np.isfinite(diag.run(0, tm.model, 5, device="cpu")["mu"]).all()
    ad = HMC(step_size=1e-3, adapt_step_size=True)
    ch = ad.run(0, tm.model, 10, num_warmup=30, num_chains=2, device="cpu")
    assert ch["mu"].shape == (2, 10, 3, 4)
    assert np.isfinite(ch.stats["logp"]).all()


def test_make_chain_fn_on_the_handwritten_twin():
    tm = tsuite.build("logreg", device="cpu", **SMALL)
    chain = make_chain_fn(tm.handwritten, 5, 0.02, 4)
    gen = torch.Generator().manual_seed(0)
    qs, logps, accs = chain(gen, torch.zeros(9))
    assert qs.shape == (5, 9) and logps.shape == accs.shape == (5,)
    qs, logps, accs = chain(gen, torch.zeros(3, 9))
    assert qs.shape == (3, 5, 9) and logps.shape == (3, 5)
    qf, logps, accs = make_chain_fn(tm.handwritten, 5, 0.02, 4,
                                    collect=False)(gen, torch.zeros(2, 9))
    assert qf.shape == (2, 9) and logps.shape == (2, 5)


def test_unported_options_raise():
    tm = tsuite.build("logreg", device="cpu", n=16, dim=2)
    with pytest.raises(ValueError, match="fused"):  # no spec given
        HMC(leapfrog="fused").make_kernel(lambda q: q.sum(), 3)
    with pytest.raises(ValueError):
        HMC(leapfrog="bogus").make_kernel(lambda q: q.sum(), 3)
    for opt in ("mesh", "checkpoint_dir", "preemption"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_chains(0, tm.model, HMC(), 2, device="cpu", **{opt: "x"})
