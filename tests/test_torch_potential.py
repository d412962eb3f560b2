"""PyTorch port: the separable-potential compiler against the JAX package.

The same models, built from the same NumPy arrays, go through
``repro.core.potential.build_potential_spec`` and the port's, with the
port's trace set to the JAX trace's flat state. Tolerances: opcodes equal,
coefficients at atol 1e-6 (both fold the same float32 parameters in
float64), ``const`` at rtol 1e-5 (a float32 log-density at the recorded
point, summed in another order). Separable: gaussian_10k, family_mix_8k
(every opcode in one table) and one site of each opcode family. Models the
port cannot compile: logreg, naive_bayes and gauss_unknown (likelihoods
move with u), hier_poisson (coupled through its likelihood), hmm_semisup
and lda (simplex sites), sto_volatility (HalfCauchy has no opcode) in both
packages, and a coupled hierarchy and eight_schools, which the JAX package
compiles to a ``CondPotentialSpec`` and the port rejects until its
dependency graph lands.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import potential as jpotential
from repro.dists import Flat as JFlat
from repro.dists import Gamma as JGamma
from repro.dists import MvNormalDiag as JMvNormalDiag
from repro.dists import Normal as JNormal
from repro.kernels.fused_leapfrog import CondPotentialSpec
from repro.models import paper_suite as jsuite
import repro_torch
from repro_torch.convert import spec_from_reference, state_from_reference
from repro_torch.core.potential import (COUPLED_NOTE, PotentialCompileResult,
                                        build_potential_spec,
                                        compile_potential)
from repro_torch.dists import Flat, Gamma, MvNormalDiag, Normal
from repro_torch.infer import HMC, run_chains
from repro_torch.kernels.fused_leapfrog import (OP_EXP, OP_NORMAL,
                                                OP_SOFTPLUS, OP_TLOG, OP_ZERO)
from repro_torch.models import family_mix
from repro_torch.models import paper_suite as tsuite


def _multi_site_pair():
    """Normal and MvNormalDiag sites with varied loc and scale, a scalar
    site, a Flat site and a parameter-free observed Normal site."""
    rng = np.random.default_rng(3)
    la = rng.normal(size=6).astype(np.float32)
    sa = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    lb = rng.normal(size=(2, 3)).astype(np.float32)
    sb = rng.uniform(0.2, 3.0, size=(2, 3)).astype(np.float32)
    y = rng.normal(size=5).astype(np.float32)

    @repro.model
    def jmulti(y):
        repro.sample("a", JNormal(jnp.asarray(la), jnp.asarray(sa)))
        repro.sample("b", JMvNormalDiag(jnp.asarray(lb), jnp.asarray(sb)))
        repro.sample("c", JNormal(1.5, 0.3))
        repro.sample("f", JFlat(jnp.zeros(4)))
        repro.observe("y", JNormal(0.5, 2.0), y)

    @repro_torch.model
    def tmulti(y):
        repro_torch.sample("a", Normal(torch.tensor(la), torch.tensor(sa)))
        repro_torch.sample("b", MvNormalDiag(torch.tensor(lb),
                                             torch.tensor(sb)))
        repro_torch.sample("c", Normal(1.5, 0.3))
        repro_torch.sample("f", Flat(torch.zeros(4)))
        repro_torch.observe("y", Normal(0.5, 2.0), y)

    return jmulti(jnp.asarray(y)), tmulti(torch.tensor(y))


def _coupled_pair():
    @repro.model
    def jchained():
        mu = repro.sample("mu", JNormal(0.0, 1.0))
        repro.sample("x", JNormal(mu * jnp.ones(3), 1.0))

    @repro_torch.model
    def tchained():
        mu = repro_torch.sample("mu", Normal(0.0, 1.0))
        repro_torch.sample("x", Normal(mu * torch.ones(3), 1.0))

    return jchained(), tchained()


def _lone_gamma_pair():
    """One Gamma site with varied concentration and rate (the ``OP_EXP``
    opcode through the log link)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 4.0, size=5).astype(np.float32)
    b = rng.uniform(0.2, 3.0, size=5).astype(np.float32)

    @repro.model
    def jgamma():
        repro.sample("s", JGamma(jnp.asarray(a), jnp.asarray(b)))

    @repro_torch.model
    def tgamma():
        repro_torch.sample("s", Gamma(torch.tensor(a), torch.tensor(b)))

    return jgamma(), tgamma()


def _family_mix_pair():
    """``family_mix_8k`` of ``benchmarks/leapfrog_bench.py``: every opcode
    but ZERO in one 8,192-D table."""
    from repro.dists import (Beta as JBeta, Cauchy as JCauchy,
                             LogNormal as JLogNormal, StudentT as JStudentT,
                             Uniform as JUniform)

    @repro.model
    def family_mix_8k():
        repro.sample("n", JNormal(jnp.zeros(2048), 2.0))
        repro.sample("g", JGamma(2.0 * jnp.ones(1024), 1.5))
        repro.sample("b", JBeta(2.0 * jnp.ones(1024), 3.0))
        repro.sample("t", JStudentT(4.0, jnp.zeros(2048), 1.0))
        repro.sample("c", JCauchy(jnp.zeros(1024), 2.0))
        repro.sample("u", JUniform(-jnp.ones(512), 1.0))
        repro.sample("l", JLogNormal(jnp.zeros(512), 1.0))

    return family_mix_8k(), family_mix.family_mix_8k(device="cpu").model


# one site per opcode family of this slice, parameters varied per element
# (the last tuple entry is a scalar parameter where the family has one)
LONE_FAMILIES = {
    "LogNormal": ("real", "pos"), "HalfNormal": ("pos",),
    "InverseGamma": ("pos", "pos"), "Exponential": ("pos",),
    "Beta": ("pos", "pos"), "Uniform": ("low", "high"),
    "StudentT": ("df", "real", "pos"), "Cauchy": ("real", "pos"),
}


def _lone_pair(family):
    import repro.dists as jd
    import repro_torch.dists as td

    rng = np.random.default_rng(len(family))
    draw = {"real": lambda: rng.normal(size=6),
            "pos": lambda: rng.uniform(0.3, 3.0, size=6),
            "df": lambda: rng.uniform(1.0, 20.0, size=6),
            "low": lambda: rng.uniform(-2.0, -0.5, size=6),
            "high": lambda: rng.uniform(0.5, 2.0, size=6)}
    params = [draw[k]().astype(np.float32) for k in LONE_FAMILIES[family]]

    @repro.model
    def jlone():
        repro.sample("s", getattr(jd, family)(*map(jnp.asarray, params)))

    @repro_torch.model
    def tlone():
        repro_torch.sample("s", getattr(td, family)(*map(torch.tensor,
                                                         params)))

    return jlone(), tlone()


def _suite_pair(name, **kw):
    return (jsuite.build(name, **kw).model,
            tsuite.build(name, device="cpu", **kw).model)


PAIRS = {
    "gaussian_10k": lambda: _suite_pair("gaussian_10k"),
    "multi_site": _multi_site_pair,
    "logreg": lambda: _suite_pair("logreg", n=64, dim=4),
    "naive_bayes": lambda: _suite_pair("naive_bayes", n=64, n_classes=3,
                                       dim=4),
    "coupled": _coupled_pair,
    "lone_gamma": _lone_gamma_pair,
    "hier_poisson": lambda: _suite_pair("hier_poisson", n=20, n_groups=4),
    "hmm_semisup": lambda: _suite_pair("hmm_semisup", K=3, V=6, T=30,
                                       T_sup=10),
    "lda": lambda: _suite_pair("lda", V=12, K=3, D=4, avg_len=30),
    "family_mix_8k": _family_mix_pair,
    "gauss_unknown": lambda: _suite_pair("gauss_unknown", n=64),
    "sto_volatility": lambda: _suite_pair("sto_volatility", T=40),
    "eight_schools": lambda: _suite_pair("eight_schools"),
    **{f"lone_{f}": (lambda f=f: _lone_pair(f)) for f in LONE_FAMILIES},
}


@functools.lru_cache(maxsize=None)
def _compile_both(name):
    """Both compilers' results on one model, once a module for each model
    (the results and traces are never changed by a test)."""
    jm, tm = PAIRS[name]()
    jtvi = jm.typed_varinfo(jax.random.PRNGKey(0)).link()
    sig = tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                for s in jtvi.layout.sites)
    ttvi = tm.typed_varinfo(torch.Generator().manual_seed(0)).link()
    ttvi = state_from_reference(ttvi, np.array(jtvi.flat()), sig)
    jres = jpotential.compile_potential(jm, jtvi, backend="fused")
    tres = compile_potential(tm, ttvi, backend="fused")
    return jres, tres, tm, ttvi


@pytest.mark.parametrize("name", ["gaussian_10k", "multi_site"])
def test_separable_specs_equal_the_reference(name):
    jres, tres, _, _ = _compile_both(name)
    assert jres.kind == tres.kind == "separable"
    js, ts = jres.spec, tres.spec
    assert ts.dim == js.dim and ts.uniform_op == js.uniform_op
    np.testing.assert_array_equal(ts.op, js.op)
    for f in ("c0", "c1", "c2", "c3"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(ts.const, js.const, rtol=1e-5)
    if name == "gaussian_10k":
        assert ts.uniform_op == OP_NORMAL and ts.dim == 10_000
    else:
        assert ts.uniform_op is None
        assert set(np.unique(ts.op)) == {OP_ZERO, OP_NORMAL}


def _assert_specs_equal(js, ts):
    """Opcodes equal, coefficients at atol 1e-6, const at rtol 1e-5."""
    assert ts.dim == js.dim and ts.uniform_op == js.uniform_op
    np.testing.assert_array_equal(ts.op, js.op)
    for f in ("c0", "c1", "c2", "c3"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(ts.const, js.const, rtol=1e-5)


def test_family_mix_8k_spec_equals_the_reference():
    jres, tres, _, _ = _compile_both("family_mix_8k")
    assert jres.kind == tres.kind == "separable"
    _assert_specs_equal(jres.spec, tres.spec)
    assert tres.spec.dim == 8192 and tres.spec.uniform_op is None
    assert set(np.unique(tres.spec.op)) == {OP_NORMAL, OP_EXP, OP_SOFTPLUS,
                                            OP_TLOG}


@pytest.mark.parametrize("family", sorted(LONE_FAMILIES))
def test_each_new_opcode_family_spec_equals_the_reference(family):
    jres, tres, _, _ = _compile_both(f"lone_{family}")
    assert jres.kind == tres.kind == "separable"
    _assert_specs_equal(jres.spec, tres.spec)


@pytest.mark.parametrize("name,reason,evals", [
    ("gauss_unknown", "mismatch at probe point 1 of 2", 5),
    ("sto_volatility", "no opcode for HalfCauchy", 0),
    ("eight_schools", "mismatch at probe point 1 of 2", 5)])
def test_this_slices_paper_models_compile_to_none(name, reason, evals,
                                                  monkeypatch):
    """sto_volatility's HalfCauchy has no opcode in either package.
    gauss_unknown (m's scale depends on s) and eight_schools are coupled
    hierarchies that the JAX package compiles to a ``CondPotentialSpec``
    and the port rejects until its dependency graph lands (ROADMAP.md
    Queue 1 item 5). The compiler's log-density evaluations are what a
    run's launch counts include."""
    jres, tres, _, _ = _compile_both(name)
    assert tres.spec is None and reason in tres.reason
    if name == "sto_volatility":
        assert jres.spec is None
    else:
        assert isinstance(jres.spec, CondPotentialSpec)
    kw = {"gauss_unknown": dict(n=64), "sto_volatility": dict(T=40),
          "eight_schools": {}}[name]
    res, calls = _count_compiler_evaluations(
        tsuite.build(name, device="cpu", **kw), monkeypatch)
    assert res.spec is None and calls == evals


def test_lone_gamma_spec_equals_the_reference():
    jres, tres, _, _ = _compile_both("lone_gamma")
    assert jres.kind == tres.kind == "separable"
    js, ts = jres.spec, tres.spec
    assert ts.uniform_op == js.uniform_op == OP_EXP and ts.dim == js.dim == 5
    for f in ("c0", "c1", "c2", "c3"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(ts.const, js.const, rtol=1e-5)


@pytest.mark.parametrize("name", ["hier_poisson", "hmm_semisup", "lda"])
def test_new_paper_models_compile_to_none_in_both(name):
    """Both packages reject the three models, with reasons that differ (see
    ROADMAP.md Queue 3): the port stops at the simplex sites of
    hmm_semisup and lda before any probe, and finds hier_poisson's
    coupling through its likelihood at probe point 1."""
    jres, tres, _, _ = _compile_both(name)
    assert jres.spec is None and tres.spec is None
    if name == "hier_poisson":
        assert "mismatch at probe point 1 of 2" in tres.reason
        assert tres.reason.endswith(COUPLED_NOTE)
    else:
        assert tres.reason == "non-elementwise support simplex"


@pytest.mark.parametrize("name", ["logreg", "naive_bayes"])
def test_likelihood_models_compile_to_none_in_both(name):
    jres, tres, tm, ttvi = _compile_both(name)
    assert jres.spec is None and tres.spec is None
    assert "mismatch at probe point" in tres.reason
    assert tres.reason.endswith(COUPLED_NOTE)
    assert build_potential_spec(tm, ttvi) is None


def test_coupled_hierarchy_waits_for_the_conditional_spec():
    jres, tres, _, _ = _compile_both("coupled")
    assert isinstance(jres.spec, CondPotentialSpec)
    assert tres == PotentialCompileResult(reason=tres.reason)
    assert "ROADMAP.md Queue 1 item 5" in tres.reason


def test_spec_from_reference_checks_lengths():
    jres, tres, _, _ = _compile_both("multi_site")
    js = jres.spec
    ts = spec_from_reference(js.op, js.c0, js.c1, js.c2, js.c3, js.const,
                             js.dim)
    assert ts.uniform_op == tres.spec.uniform_op
    np.testing.assert_array_equal(ts.c1, tres.spec.c1)
    with pytest.raises(ValueError, match="c2 has shape"):
        spec_from_reference(js.op, js.c0, js.c1, js.c2[:-1], js.c3,
                            js.const, js.dim)


def test_fused_leapfrog_on_logreg_raises_with_the_compilers_reason():
    tm = tsuite.build("logreg", device="cpu", n=64, dim=4)
    with pytest.raises(ValueError, match="mismatch at probe point") as info:
        run_chains(0, tm.model, HMC(leapfrog="fused"), 2, device="cpu")
    assert "ROADMAP.md Queue 1 item 5" in str(info.value)
    # auto falls back to autodiff and keeps the reason on the kernel
    ttvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    res = compile_potential(tm.model, ttvi)
    kern = HMC(leapfrog="auto").make_kernel(
        tm.model.make_logdensity_fn(ttvi), ttvi.num_flat, spec=res.spec,
        spec_reason=res.reason)
    assert kern.spec_reason == res.reason
    ch = run_chains(0, tm.model, HMC(step_size=0.02), 5, device="cpu")
    assert np.isfinite(ch.stats["logp"]).all()


def _count_compiler_evaluations(tm, monkeypatch):
    """(compile result, log-density evaluations the compiler made)."""
    ttvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    make = type(tm.model).make_logdensity_fn
    calls = []

    def counted(self, *args, **kwargs):
        ld = make(self, *args, **kwargs)

        def f(u):
            calls.append(1)
            return ld(u)
        return f

    monkeypatch.setattr(type(tm.model), "make_logdensity_fn", counted)
    return compile_potential(tm.model, ttvi), len(calls)


@pytest.mark.parametrize("name", ["gaussian_10k", "logreg"])
def test_compiler_always_makes_five_evaluations(name, monkeypatch):
    """For a model whose every site has an opcode (here gaussian_10k and
    logreg): the value at the recorded point, then a value and a gradient
    at each of two probe points, whatever the verdict (gaussian_10k
    compiles, logreg fails at probe point 1). A model with a simplex site
    is rejected before any probe: see
    ``test_compiler_probe_evaluations_per_paper_model``."""
    kw = {"dim": 16} if name == "gaussian_10k" else {"n": 64, "dim": 4}
    tm = tsuite.build(name, device="cpu", **kw)
    res, calls = _count_compiler_evaluations(tm, monkeypatch)
    assert (res.spec is not None) == (name == "gaussian_10k")
    assert calls == 5


@pytest.mark.parametrize("name,evals", [("hier_poisson", 5),
                                        ("hmm_semisup", 0), ("lda", 0)])
def test_compiler_probe_evaluations_per_paper_model(name, evals, monkeypatch):
    """hier_poisson's sites all have opcodes, so the compiler makes its 5
    evaluations and then finds the coupling; hmm_semisup's and lda's
    simplex sites stop it before the first (so their runs launch no probe
    kernels)."""
    kw = {"hier_poisson": dict(n=20, n_groups=4),
          "hmm_semisup": dict(K=3, V=6, T=30, T_sup=10),
          "lda": dict(V=12, K=3, D=4, avg_len=30)}[name]
    tm = tsuite.build(name, device="cpu", **kw)
    res, calls = _count_compiler_evaluations(tm, monkeypatch)
    assert res.spec is None and calls == evals


def test_compiler_raises_a_kernel_failure(monkeypatch):
    """A kernel that fails in the probes fails the compile; any other error
    of the replay becomes a reason and the autodiff integrator."""
    from repro_torch.kernels._build import KernelError

    tm = tsuite.build("gaussian_10k", device="cpu", dim=8)
    ttvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()

    def failing(exc):
        def make(self, *args, **kwargs):
            def ld(u):
                raise exc
            return ld
        return make

    monkeypatch.setattr(type(tm.model), "make_logdensity_fn",
                        failing(KernelError("std_normal_sum launch failed")))
    with pytest.raises(KernelError, match="launch failed"):
        compile_potential(tm.model, ttvi)
    monkeypatch.setattr(type(tm.model), "make_logdensity_fn",
                        failing(RuntimeError("shape mismatch")))
    res = compile_potential(tm.model, ttvi)
    assert res.spec is None
    assert res.reason == "spec compilation failed: shape mismatch"
