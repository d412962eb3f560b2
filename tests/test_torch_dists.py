"""PyTorch port: the stick-breaking link and the distributions of the
categorical/gamma slice (``Categorical``, ``Dirichlet``, ``Gamma``,
``Poisson``), held against the JAX package on the same NumPy inputs.

Tolerances: ``log_prob`` at rtol 1e-5; the stick-breaking round trip at
atol 1e-4 (the JAX package's own bound, which its float32 inverse misses
at ``x = [3] * 5``; see ROADMAP.md Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bijectors as jb
from repro.dists import Categorical as JCategorical
from repro.dists import Dirichlet as JDirichlet
from repro.dists import Gamma as JGamma
from repro.dists import Poisson as JPoisson
from repro_torch.bijectors import StickBreaking
from repro_torch.dists import Categorical, Dirichlet, Gamma, Poisson


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
    jg = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(x)))
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
