"""PyTorch port: the two synthetic family mixes against the JAX package.

``family_mix_8k`` (``benchmarks/leapfrog_bench.py``: 8,192-D, seven
families) and ``mixed`` (``tests/test_kernel_families.py``: Gamma, Beta,
StudentT, a dense 5-D MvNormal and Normal) are built in both packages from
the same NumPy arrays; the port's trace is set to the JAX trace's flat
state. Tolerances: value rtol 1e-5; gradient rtol 1e-5 with atol 1e-5 *
max|g| (float32 sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.dists import (Beta, Cauchy, Gamma, LogNormal, MvNormal, Normal,
                         StudentT, Uniform)
from repro_torch.convert import layout_signature, state_from_reference
from repro_torch.infer import HMC, run_chains
from repro_torch.infer.hmc import value_and_grad
from repro_torch.kernels.fused_logpdf import ops
from repro_torch.models import family_mix


def _jax_family_mix_8k():
    @repro.model
    def family_mix_8k():
        repro.sample("n", Normal(jnp.zeros(2048), 2.0))
        repro.sample("g", Gamma(2.0 * jnp.ones(1024), 1.5))
        repro.sample("b", Beta(2.0 * jnp.ones(1024), 3.0))
        repro.sample("t", StudentT(4.0, jnp.zeros(2048), 1.0))
        repro.sample("c", Cauchy(jnp.zeros(1024), 2.0))
        repro.sample("u", Uniform(-jnp.ones(512), 1.0))
        repro.sample("l", LogNormal(jnp.zeros(512), 1.0))

    return family_mix_8k()


def _jax_mixed(tril):
    @repro.model
    def mixed():
        repro.sample("g", Gamma(2.0 * jnp.ones(16), 1.5))
        repro.sample("b", Beta(2.0, 3.0))
        repro.sample("t", StudentT(4.0, 0.0, jnp.ones(8)))
        repro.sample("mv", MvNormal(jnp.zeros(5), jnp.asarray(tril)))
        repro.sample("n", Normal(jnp.zeros(4), 2.0))

    return mixed()


def _jax_test_tril():
    """The Cholesky factor ``tests/test_kernel_families.py`` draws."""
    a = 0.2 * jax.random.normal(jax.random.PRNGKey(0), (5, 5))
    return np.asarray(jnp.linalg.cholesky(a @ a.T + jnp.eye(5)), np.float32)


@functools.lru_cache(maxsize=None)
def _pair(name, tril=None):
    """Both packages' model and linked trace, once a module for each model
    and factor: ``tril`` None is the port's default factor, "jax_test" the
    one ``tests/test_kernel_families.py`` draws."""
    if name == "family_mix_8k":
        jm, tm = _jax_family_mix_8k(), family_mix.family_mix_8k(device="cpu")
    else:
        tril = (family_mix.mixed_scale_tril() if tril is None
                else _jax_test_tril())
        jm, tm = _jax_mixed(tril), family_mix.mixed(tril, device="cpu")
    jlinked = jm.typed_varinfo(jax.random.PRNGKey(1)).link()
    sig = tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                for s in jlinked.layout.sites)
    tlinked = tm.model.typed_varinfo(torch.Generator().manual_seed(1)).link()
    assert layout_signature(tlinked) == sig
    return jm, tm, jlinked, state_from_reference(
        tlinked, np.array(jlinked.flat()), sig)


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("name,tril", [
    ("family_mix_8k", None), ("mixed", None), ("mixed", "jax_test")])
def test_density_and_gradient_match_jax(name, tril):
    jm, tm, jlinked, tlinked = _pair(name, tril)
    rng = np.random.default_rng(2)
    jfun = jax.jit(jax.value_and_grad(jm.make_logdensity_fn(jlinked)))
    for k in range(2):
        u = (np.asarray(jlinked.flat())
             + 0.3 * rng.normal(size=jlinked.num_flat)).astype(np.float32)
        jv, jg = jfun(jnp.asarray(u))
        for backend in ("fused", "reference"):
            v, g = value_and_grad(tm.model.make_logdensity_fn(
                tlinked, backend=backend))(torch.tensor(u))
            _close(v, jv)
            _grad_close(g, jg)


def test_mixed_fused_blocks_and_batched_factor(monkeypatch):
    """The fused log-joint of ``mixed`` sends one block to each of five
    families (mvnormal_prec, beta, student_t, gamma, std_normal); an
    MvNormal with a batched Cholesky factor takes the per-site path, as in
    the JAX package."""
    from repro_torch.core.interpreters import _fusible_parts
    from repro_torch.dists import MvNormal as TMvNormal

    _, tm, _, tlinked = _pair("mixed")
    families = []
    orig = ops.site_block_sum

    def spy(family, segments):
        families.append((family, len(segments)))
        return orig(family, segments)

    monkeypatch.setattr(ops, "site_block_sum", spy)
    tm.model.make_logdensity_fn(tlinked)(tlinked.flat())
    assert sorted(families) == sorted([
        ("gamma", 1), ("beta", 1), ("student_t", 1), ("mvnormal_prec", 1),
        ("std_normal", 1)])
    tril = torch.tensor(family_mix.mixed_scale_tril())
    assert _fusible_parts(TMvNormal(torch.zeros(5), tril.expand(2, 5, 5)),
                          torch.zeros(2, 5)) is None


def test_family_mix_8k_fused_and_autodiff_integrators_agree():
    """A short run of each integrator from the same seed, as ``chip_smoke.py``
    runs them on the card: the first draws agree (the fused integrator's
    plain version on the CPU)."""
    pm = family_mix.family_mix_8k(device="cpu")
    runs = {lf: run_chains(0, pm.model, HMC(step_size=pm.step_size,
                                            n_leapfrog=4, leapfrog=lf),
                           3, num_chains=2, device="cpu")
            for lf in ("auto", "reference")}
    for site in runs["auto"].names():
        a, b = runs["auto"][site], runs["reference"][site]
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(runs["auto"].stats["logp"],
                               runs["reference"].stats["logp"], rtol=1e-5)
