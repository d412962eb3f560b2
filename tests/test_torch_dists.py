"""PyTorch port: the stick-breaking link and the distribution families,
held against the JAX package on the same NumPy inputs: ``Categorical``,
``Dirichlet``, ``Gamma`` and ``Poisson``, then the other 18 families and
the per-array switch. Samples are held to their law's mean (scipy.stats)
within 5 standard errors.

Tolerances: ``log_prob`` at rtol 1e-5; the stick-breaking round trip at
atol 1e-4 (the JAX package's own bound, which its float32 inverse misses
at ``x = [3] * 5``; see ROADMAP.md Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import repro.bijectors as jb
import repro.dists as jd
from repro.dists import Categorical as JCategorical
from repro.dists import Dirichlet as JDirichlet
from repro.dists import Gamma as JGamma
from repro.dists import Poisson as JPoisson
from repro_torch.bijectors import StickBreaking
from repro_torch.dists import (Bernoulli, BernoulliLogits, Beta, Binomial,
                               Categorical, Cauchy, Dirichlet,
                               DiscreteUniform, Exponential, Gamma,
                               HalfCauchy, HalfNormal, InverseGamma, Laplace,
                               LogisticDist, LogNormal, MixtureSameFamily,
                               Multinomial, MvNormal, Normal, Poisson,
                               StudentT, TruncatedNormal, Uniform)


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# stick-breaking: the repaired inverse
# ---------------------------------------------------------------------------
def test_stickbreaking_roundtrip_at_the_reference_counterexample():
    """``x = [3] * 5`` is the counterexample the JAX package's round-trip
    property test saved: its ``1 - cumsum`` remainder gives 1.4e-3 there."""
    sb = StickBreaking()
    x = torch.full((5,), 3.0)
    y = sb.forward(x)
    np.testing.assert_allclose(sb.inverse(y).numpy(), x.numpy(), rtol=0,
                               atol=1e-4)
    # the same y through a float64 inverse: nothing is lost in float32
    np.testing.assert_allclose(sb.inverse(y).numpy(),
                               sb.inverse(y.double()).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 5, 19, 99])
def test_stickbreaking_inverse_loses_nothing_on_all_of_the_range(k):
    """On x in [-10, 10]^k the float32 inverse of the float32 forward
    equals a float64 inverse of the same y within 1e-4: the tail sums keep
    the entries far below the float32 epsilon that ``1 - cumsum`` lost."""
    sb = StickBreaking()
    rng = np.random.default_rng(k)
    x = torch.tensor(rng.uniform(-10.0, 10.0, size=(64, k)),
                     dtype=torch.float32)
    y = sb.forward(x)
    assert float(y.min()) < 1e-4  # the range reaches the tiny entries
    np.testing.assert_allclose(sb.inverse(y).numpy(),
                               sb.inverse(y.double()).numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 5, 19, 99])
def test_stickbreaking_roundtrip_on_random_inputs(k):
    """``inverse(forward(x)) == x`` within 1e-4 for x in [-10, 6]^k. Above
    6 the forward (unchanged, so that densities equal the JAX package's)
    forms ``1 - sigmoid(x - offset)`` in float32, which keeps under 1e-5
    of the stick's relative size only up to there; the inverse cannot
    give back what the forward dropped (the test above holds the inverse
    on all of [-10, 10])."""
    sb = StickBreaking()
    rng = np.random.default_rng(100 + k)
    x = torch.tensor(rng.uniform(-10.0, 6.0, size=(64, k)),
                     dtype=torch.float32)
    np.testing.assert_allclose(sb.inverse(sb.forward(x)).numpy(), x.numpy(),
                               rtol=0, atol=1e-4)


def test_stickbreaking_inverse_matches_the_reference_where_it_holds():
    """Compared with the JAX package's inverse only on the rows where the
    JAX package's own round trip holds 1e-4."""
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 2.0, size=(200, 6)).astype(np.float32)
    jsb = jb.StickBreaking()
    jy = np.asarray(jsb.forward(jnp.asarray(x)))
    jx = np.asarray(jsb.inverse(jnp.asarray(jy)))
    holds = np.all(np.abs(jx - x) <= 1e-4, axis=-1)
    assert holds.sum() >= 100
    got = StickBreaking().inverse(torch.tensor(jy[holds])).numpy()
    np.testing.assert_allclose(got, jx[holds], rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [1, 4, 99])
def test_stickbreaking_gradients_match_jax_under_vmap(k):
    """The forward and its log-det-Jacobian differentiated over a batch of
    chains (the port's cumprod carries its closed-form backward) against
    ``jax.grad`` of the JAX package's; the forward values equal a plain
    ``torch.cumprod`` bit for bit."""
    rng = np.random.default_rng(200 + k)
    x = rng.normal(0.0, 2.0, size=(3, 2, k)).astype(np.float32)
    w = rng.normal(size=(2, k + 1)).astype(np.float32)
    sb, jsb = StickBreaking(), jb.StickBreaking()

    def f(u):
        return (torch.sum(sb.forward(u) * torch.tensor(w))
                + sb.forward_log_det_jacobian(u))

    def jf(u):
        return jnp.sum(jsb.forward(u) * w) + jsb.forward_log_det_jacobian(u)

    g = torch.func.vmap(torch.func.grad(f))(torch.tensor(x)).numpy()
    jg = np.asarray(jax.jit(jax.vmap(jax.grad(jf)))(jnp.asarray(x)))
    np.testing.assert_allclose(g, jg, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()))
    xt = torch.tensor(x)
    z = torch.sigmoid(xt - torch.log(torch.arange(k, 0, -1.0)))
    one_minus = torch.cumprod(1.0 - z, dim=-1)
    assert torch.equal(sb.forward(xt)[..., -1], one_minus[..., -1])


# ---------------------------------------------------------------------------
# log_prob against the JAX package
# ---------------------------------------------------------------------------
def test_categorical_log_prob_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0.0, 2.0, size=(4, 6, 5)).astype(np.float32)
    x = rng.integers(0, 5, size=(4, 6)).astype(np.int32)
    d = Categorical(torch.tensor(logits))
    _close(d.log_prob(torch.tensor(x)),
           JCategorical(jnp.asarray(logits)).log_prob(jnp.asarray(x)))
    # labels shared over the batch
    _close(d.log_prob(torch.tensor(x[0])),
           JCategorical(jnp.asarray(logits)).log_prob(
               jnp.broadcast_to(jnp.asarray(x[0]), (4, 6))))
    assert d.batch_shape == (4, 6) and d.shape == (4, 6)
    assert d.event_shape == () and d.num_categories == 5


def test_dirichlet_log_prob_matches_jax():
    rng = np.random.default_rng(2)
    conc = rng.uniform(0.3, 3.0, size=(3, 7)).astype(np.float32)
    x = rng.dirichlet(np.ones(7), size=3).astype(np.float32)
    _close(Dirichlet(torch.tensor(conc)).log_prob(torch.tensor(x)),
           JDirichlet(jnp.asarray(conc)).log_prob(jnp.asarray(x)))
    assert Dirichlet(torch.tensor(conc)).shape == (3, 7)


def test_gamma_log_prob_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 6.0, size=(4, 5)).astype(np.float32)
    a = rng.uniform(0.5, 4.0, size=5).astype(np.float32)
    b = rng.uniform(0.2, 3.0, size=5).astype(np.float32)
    t = torch.tensor
    _close(Gamma(t(a), t(b)).log_prob(t(x)),
           JGamma(jnp.asarray(a), jnp.asarray(b)).log_prob(jnp.asarray(x)))
    _close(Gamma(1.0, 1.0).log_prob(t(x)), JGamma(1.0, 1.0).log_prob(x))
    _close(Gamma(2.5, 0.5).log_prob(t(x)), JGamma(2.5, 0.5).log_prob(x))


def test_poisson_log_prob_matches_jax():
    rng = np.random.default_rng(4)
    rate = rng.uniform(0.1, 20.0, size=(3, 8)).astype(np.float32)
    y = rng.poisson(rate).astype(np.int32)
    _close(Poisson(torch.tensor(rate)).log_prob(torch.tensor(y)),
           JPoisson(jnp.asarray(rate)).log_prob(jnp.asarray(y)))
    _close(Poisson(3.0).log_prob(torch.tensor(y)), JPoisson(3.0).log_prob(y))


# ---------------------------------------------------------------------------
# sampling: shape, dtype and support, from an explicit generator
# ---------------------------------------------------------------------------
def test_categorical_samples():
    gen = torch.Generator().manual_seed(0)
    d = Categorical(torch.randn(4, 6, generator=gen))
    draw = d.sample(gen)
    assert draw.shape == (4,) and draw.dtype == torch.int32
    assert bool(d.in_support(draw))
    many = d.sample(gen, (3, 2))
    assert many.shape == (3, 2, 4) and bool(d.in_support(many))
    # one class carries all the mass: every draw is that class
    sure = Categorical(torch.tensor([[-1e9, 0.0, -1e9]] * 5)).sample(gen, (7,))
    assert sure.tolist() == [[1] * 5] * 7
    again = d.sample(torch.Generator().manual_seed(5))
    assert torch.equal(again, d.sample(torch.Generator().manual_seed(5)))


def test_dirichlet_samples():
    gen = torch.Generator().manual_seed(1)
    d = Dirichlet(torch.full((5, 100), 0.5))
    draw = d.sample(gen)
    assert draw.shape == (5, 100) and draw.dtype == torch.float32
    assert bool(d.in_support(draw)) and bool((draw >= 0).all())
    torch.testing.assert_close(draw.sum(-1), torch.ones(5), rtol=0, atol=1e-5)
    assert d.sample(gen, (2,)).shape == (2, 5, 100)


def test_gamma_samples():
    gen = torch.Generator().manual_seed(2)
    d = Gamma(torch.tensor([0.5, 2.0, 9.0]), 2.0)
    draw = d.sample(gen, (4000,))
    assert draw.shape == (4000, 3) and draw.dtype == torch.float32
    assert bool(d.in_support(draw))
    # mean a / b within 5 standard errors (sd sqrt(a) / b / sqrt(n))
    a = torch.tensor([0.5, 2.0, 9.0])
    se = a.sqrt() / 2.0 / 4000 ** 0.5
    assert bool(((draw.mean(0) - a / 2.0).abs() < 5 * se).all())
    assert Gamma(1.0, 1.0).sample(gen).shape == ()


def test_poisson_samples():
    gen = torch.Generator().manual_seed(3)
    d = Poisson(torch.tensor([0.5, 4.0]))
    draw = d.sample(gen, (3,))
    assert draw.shape == (3, 2) and draw.dtype == torch.int32
    assert bool(d.in_support(draw))


# ---------------------------------------------------------------------------
# the other 18 families: log_prob against the JAX package, samples
# ---------------------------------------------------------------------------
def _families(rng):
    """name -> (port class, JAX class, parameters (NumPy), values (NumPy))
    for the 12 continuous and 3 discrete families the earlier slices left;
    the three multivariate ones are tested below."""
    f32 = np.float32
    u = rng.uniform
    pos = u(0.05, 4.0, size=(3, 5)).astype(f32)
    real = rng.normal(0.0, 2.0, size=(3, 5)).astype(f32)
    unit = u(0.02, 0.98, size=(3, 5)).astype(f32)
    loc = rng.normal(size=5).astype(f32)
    scale = u(0.5, 2.0, size=5).astype(f32)
    counts = rng.integers(0, 8, size=(3, 5)).astype(np.int32)
    return {
        "LogNormal": (LogNormal, jd.LogNormal, (loc, scale), pos),
        "HalfNormal": (HalfNormal, jd.HalfNormal, (scale,), pos),
        "Cauchy": (Cauchy, jd.Cauchy, (loc, scale), real),
        "HalfCauchy": (HalfCauchy, jd.HalfCauchy, (scale,), pos),
        "StudentT": (StudentT, jd.StudentT,
                     (u(1.0, 30.0, 5).astype(f32), loc, scale), real),
        "Uniform": (Uniform, jd.Uniform, (f32(-1.5), f32(2.5)), real),
        "Beta": (Beta, jd.Beta, (u(0.3, 4.0, 5).astype(f32),
                                 u(0.3, 4.0, 5).astype(f32)), unit),
        "InverseGamma": (InverseGamma, jd.InverseGamma,
                         (u(0.5, 4.0, 5).astype(f32), scale), pos),
        "Exponential": (Exponential, jd.Exponential, (scale,), pos),
        "Laplace": (Laplace, jd.Laplace, (loc, scale), real),
        "LogisticDist": (LogisticDist, jd.LogisticDist, (loc, scale), real),
        "TruncatedNormal": (TruncatedNormal, jd.TruncatedNormal,
                            (loc, scale, f32(-1.0), f32(2.0)), real),
        "Bernoulli": (Bernoulli, jd.Bernoulli, (unit[0],),
                      (counts % 2).astype(np.int32)),
        "Binomial": (Binomial, jd.Binomial,
                     (np.int32(7), unit[0]), counts),
        "DiscreteUniform": (DiscreteUniform, jd.DiscreteUniform,
                            (np.int32(1), np.int32(5)), counts),
    }


FAMILY_NAMES = sorted(_families(np.random.default_rng(0)))


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_new_family_log_prob_matches_jax(name):
    tcls, jcls, params, x = _families(np.random.default_rng(11))[name]
    tp = [torch.tensor(p) for p in params]
    got = tcls(*tp).log_prob(torch.tensor(x))
    want = jcls(*map(jnp.asarray, params)).log_prob(jnp.asarray(x))
    want = np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    # |a - b| <= 1e-5 (1 + |b|), the JAX package's own measure in
    # tests/test_kernel_families.py: terms of size ~10 (lgamma, xlogy)
    # cancel to densities near 0
    _close(got.numpy()[finite], want[finite], atol=1e-5)
    assert tcls(*tp).shape == jcls(*map(jnp.asarray, params)).shape
    assert tcls.support == jcls.support
    assert tuple(f.name for f in dataclasses.fields(tcls)) == \
        tuple(f.name for f in dataclasses.fields(jcls))
    # Python numbers as parameters give the same density
    if all(np.ndim(p) == 0 for p in params):
        _close(tcls(*map(float, params)).log_prob(torch.tensor(x)),
               got.numpy(), atol=1e-5)


# (class, parameters, scipy.stats frozen distribution with the same law)
MOMENTS = {
    "LogNormal": (LogNormal, (0.2, 0.5), stats.lognorm(0.5, scale=np.exp(0.2))),
    "HalfNormal": (HalfNormal, (1.5,), stats.halfnorm(scale=1.5)),
    "StudentT": (StudentT, (5.0, 1.0, 2.0), stats.t(5.0, 1.0, 2.0)),
    "Uniform": (Uniform, (-1.0, 3.0), stats.uniform(-1.0, 4.0)),
    "Beta": (Beta, (2.0, 5.0), stats.beta(2.0, 5.0)),
    "InverseGamma": (InverseGamma, (5.0, 2.0), stats.invgamma(5.0, scale=2.0)),
    "Exponential": (Exponential, (2.5,), stats.expon(scale=0.4)),
    "Laplace": (Laplace, (1.0, 0.5), stats.laplace(1.0, 0.5)),
    "LogisticDist": (LogisticDist, (-1.0, 0.7), stats.logistic(-1.0, 0.7)),
    "TruncatedNormal": (TruncatedNormal, (0.5, 1.0, -1.0, 1.5),
                        stats.truncnorm(-1.5, 1.0, 0.5, 1.0)),
    "Bernoulli": (Bernoulli, (0.3,), stats.bernoulli(0.3)),
    "Binomial": (Binomial, (12, 0.35), stats.binom(12, 0.35)),
    "DiscreteUniform": (DiscreteUniform, (2, 7), stats.randint(2, 8)),
}


@pytest.mark.parametrize("name", sorted(MOMENTS) + ["Cauchy", "HalfCauchy"])
def test_new_family_samples_shape_support_and_moments(name):
    """Draws of shape sample_shape + batch shape, in the support, with the
    law's mean within 5 standard errors (its median for the two Cauchy
    families, which have no mean)."""
    gen = torch.Generator().manual_seed(17)
    n = 40000
    if name in ("Cauchy", "HalfCauchy"):
        d = Cauchy(1.0, 2.0) if name == "Cauchy" else HalfCauchy(2.0)
        draw = d.sample(gen, (n,))
        assert draw.shape == (n,) and bool(d.in_support(draw))
        median, sd = (1.0, 0.5 * np.pi * 2.0) if name == "Cauchy" else \
            (2.0, 0.25 * np.pi * 2.0 * (1.0 + 1.0) ** 2 / 2.0)
        assert abs(float(draw.median()) - median) < 5 * sd / np.sqrt(n)
        return
    cls, params, law = MOMENTS[name]
    d = cls(*params)
    draw = d.sample(gen, (n,))
    assert draw.shape == (n,) and bool(d.in_support(draw))
    assert draw.dtype == (torch.int32 if cls.support in
                          ("binary", "nonnegative_int", "discrete")
                          else torch.float32)
    se = law.std() / np.sqrt(n)
    assert abs(float(draw.double().mean()) - law.mean()) < 5 * se
    batched = cls(*[torch.full((2, 3), float(p)) for p in params])
    assert batched.sample(gen, (4,)).shape == (4, 2, 3)


def test_mvnormal_log_prob_shapes_and_samples_match_jax():
    rng = np.random.default_rng(12)
    a = rng.normal(0.0, 0.4, size=(4, 4))
    tril = np.linalg.cholesky(a @ a.T + np.eye(4)).astype(np.float32)
    loc = rng.normal(size=4).astype(np.float32)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    d, jdist = MvNormal(torch.tensor(loc), torch.tensor(tril)), \
        jd.MvNormal(jnp.asarray(loc), jnp.asarray(tril))
    _close(d.log_prob(torch.tensor(x)), jdist.log_prob(jnp.asarray(x)))
    assert d.batch_shape == () and d.event_shape == (4,)
    batched = MvNormal(torch.zeros(3, 4), torch.tensor(tril))
    assert batched.batch_shape == (3,) and batched.shape == (3, 4)
    # a batched Cholesky factor, one per row
    trils = np.stack([tril, np.eye(4, dtype=np.float32)])
    _close(MvNormal(torch.tensor(loc), torch.tensor(trils)).log_prob(
        torch.tensor(x[:2])), jd.MvNormal(jnp.asarray(loc), jnp.asarray(
            trils)).log_prob(jnp.asarray(x[:2])))
    gen = torch.Generator().manual_seed(4)
    draw = d.sample(gen, (20000,))
    assert draw.shape == (20000, 4)
    cov = tril.astype(np.float64) @ tril.T
    np.testing.assert_allclose(draw.double().mean(0).numpy(), loc,
                               atol=5 * np.sqrt(cov.diagonal().max() / 20000))
    np.testing.assert_allclose(np.cov(draw.double().numpy().T), cov,
                               atol=0.1)


def test_multinomial_log_prob_and_samples_match_jax():
    rng = np.random.default_rng(13)
    probs = rng.dirichlet(np.ones(5), size=3).astype(np.float32)
    x = np.stack([rng.multinomial(9, p) for p in probs]).astype(np.int32)
    _close(Multinomial(9, torch.tensor(probs)).log_prob(torch.tensor(x)),
           jd.Multinomial(9, jnp.asarray(probs)).log_prob(jnp.asarray(x)))
    gen = torch.Generator().manual_seed(5)
    d = Multinomial(9, torch.tensor(probs))
    draw = d.sample(gen, (4000,))
    assert draw.shape == (4000, 3, 5) and draw.dtype == torch.int32
    assert bool((draw.sum(-1) == 9).all())
    np.testing.assert_allclose(draw.double().mean(0).numpy(), 9 * probs,
                               atol=5 * np.sqrt(9 * 0.25 / 4000))


def test_mixture_log_prob_and_samples_match_jax():
    rng = np.random.default_rng(14)
    logits = rng.normal(size=3).astype(np.float32)
    loc = np.array([-3.0, 0.0, 4.0], np.float32)
    scale = np.array([0.5, 1.0, 0.7], np.float32)
    x = rng.normal(0.0, 3.0, size=(7,)).astype(np.float32)
    d = MixtureSameFamily(torch.tensor(logits),
                          Normal(torch.tensor(loc), torch.tensor(scale)))
    jdist = jd.MixtureSameFamily(jnp.asarray(logits), jd.Normal(
        jnp.asarray(loc), jnp.asarray(scale)))
    _close(d.log_prob(torch.tensor(x)), jdist.log_prob(jnp.asarray(x)))
    assert d.shape == jdist.shape
    gen = torch.Generator().manual_seed(6)
    draw = d.sample(gen, (20000,))
    assert draw.shape == (20000,)
    w = np.exp(logits) / np.exp(logits).sum()
    mean = float((w * loc).sum())
    sd = float(np.sqrt((w * (scale ** 2 + loc ** 2)).sum() - mean ** 2))
    assert abs(float(draw.double().mean()) - mean) < 5 * sd / np.sqrt(20000)


def test_dists_package_exports_all_26_families():
    import repro.dists as jdists
    import repro_torch.dists as tdists
    assert sorted(tdists.__all__) == sorted(jdists.__all__)
    assert len(tdists.__all__) == 2 + 26


# ---------------------------------------------------------------------------
# the per-array switch (kernels.use_fused_logpdf)
# ---------------------------------------------------------------------------
def test_fused_logpdf_switch_routes_to_the_kernels_plain_versions(
        monkeypatch):
    """On and off give the same totals; on, Normal and BernoulliLogits (at
    least 1,024 elements) and Categorical (rank-2 logits, at least 256
    labels) go through the per-array kernels, whose CPU path is the plain
    version; below those sizes they stay plain sums."""
    from repro_torch import kernels
    from repro_torch.kernels.fused_logpdf import ops, ref

    rng = np.random.default_rng(15)
    x = torch.tensor(rng.normal(size=(40, 50)), dtype=torch.float32)
    loc = torch.tensor(rng.normal(size=50), dtype=torch.float32)
    y = torch.tensor(rng.integers(0, 2, size=2000), dtype=torch.int32)
    logits = torch.tensor(rng.normal(size=2000), dtype=torch.float32)
    clog = torch.tensor(rng.normal(size=(300, 4)), dtype=torch.float32)
    lab = torch.tensor(rng.integers(0, 4, size=300), dtype=torch.int32)
    sites = [(Normal(loc, 1.5), x), (Normal(0.5, 2.0), x[0, :10]),
             (BernoulliLogits(logits), y), (Categorical(clog), lab)]
    off = [float(d.total_log_prob(v)) for d, v in sites]
    calls = []
    for name in ("normal_logpdf_sum_ref", "bernoulli_logits_logpmf_sum_ref",
                 "categorical_logits_logpmf_sum_ref"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    with kernels.use_fused_logpdf():
        assert kernels.fused_logpdf_enabled()
        on = [float(d.total_log_prob(v)) for d, v in sites]
    assert not kernels.fused_logpdf_enabled()
    np.testing.assert_allclose(on, off, rtol=1e-5)
    assert calls == ["normal_logpdf_sum_ref",
                     "bernoulli_logits_logpmf_sum_ref",
                     "categorical_logits_logpmf_sum_ref"]
    assert ops.LAUNCHES["normal_sum"] == 0  # the CPU path counts nothing
