"""PyTorch port: bijectors, distributions, typed traces and the fused flat
log-density, held against the JAX package on the same NumPy inputs.

Models are the paper's ``logreg``, ``naive_bayes``, ``hier_poisson``,
``hmm_semisup``, ``lda``, ``gauss_unknown``, ``sto_volatility`` and
``eight_schools`` at Table 1's sizes; the data come from the same
``np.random.default_rng`` calls in both packages.
Tolerances: value rtol 1e-5; gradient rtol 1e-5 with atol 1e-5 * max|g|
(float32, sums in another order). TF32 is off (``resolve_device``).
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bijectors as jb
from repro.dists import BernoulliLogits as JBernoulliLogits
from repro.dists import MvNormalDiag as JMvNormalDiag
from repro.dists import Normal as JNormal
from repro.models import paper_suite as jsuite
from repro_torch import _device
from repro_torch import bijectors as tb
from repro_torch.convert import layout_signature, state_from_reference
from repro_torch.dists import BernoulliLogits, MvNormalDiag, Normal
from repro_torch.infer.hmc import value_and_grad
from repro_torch.models import paper_suite as tsuite
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


REPO = Path(__file__).resolve().parents[1]
# the models at their default (Table-1) sizes, the sizes
# tests/test_paper_suite.py traces op by op: in the whole run the JAX
# package's compiles of those traces are shared (each new primitive and
# shape costs an XLA compile), and test_torch_potential.py's compiler runs
# trace the same
SMALL = dict.fromkeys(["logreg", "naive_bayes", "hier_poisson", "hmm_semisup",
                       "lda", "gauss_unknown", "sto_volatility",
                       "eight_schools"], {})
MODELS = list(SMALL)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=1e-5, atol=1e-5 * float(np.max(np.abs(want))))


def _jax_trace(model, seed=0, link=False):
    """The JAX package's typed trace of ``model`` from ``PRNGKey(seed)``
    (linked with ``link``), traced and compiled as one program: the prior
    draw of op-by-op dispatch up to float32 rounding, in a fraction of the
    time on the CPU. For the models at Table 1's size, which no other test
    of the port traces op by op (the small ones share the op-by-op
    compilations with the compiler's replays in test_torch_potential.py)."""
    def trace(key):
        tvi = model.typed_varinfo(key)
        return tvi.link() if link else tvi
    return jax.jit(trace)(jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# bijectors and distributions
# ---------------------------------------------------------------------------
BIJECTORS = {
    "identity": (tb.Identity(), jb.Identity(), (5,)),
    "exp": (tb.Exp(), jb.Exp(), (5,)),
    "softplus": (tb.Softplus(), jb.Softplus(), (5,)),
    "sigmoid": (tb.Sigmoid(-1.0, 2.0), jb.Sigmoid(-1.0, 2.0), (5,)),
    "affine": (tb.Affine(0.5, 2.0), jb.Affine(0.5, 2.0), (5,)),
    "stickbreaking": (tb.StickBreaking(), jb.StickBreaking(), (3, 4)),
    "ordered": (tb.Ordered(), jb.Ordered(), (6,)),
}


@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_matches_jax(name):
    tbij, jbij, shape = BIJECTORS[name]
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    xt = torch.tensor(x)
    jy, jldj, jx = jax.jit(lambda u: (
        jbij.forward(u), jbij.forward_log_det_jacobian(u),
        jbij.inverse(jbij.forward(u))))(jnp.asarray(x))
    y = tbij.forward(xt)
    _close(y, jy)
    _close(tbij.forward_log_det_jacobian(xt), jldj)
    _close(tbij.inverse(y), jx, atol=1e-5)
    assert tuple(y.shape) == tuple(jy.shape)
    assert tbij.unconstrained_shape(y.shape) == \
        jbij.unconstrained_shape(tuple(y.shape))


def test_distributions_log_prob_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    loc = rng.normal(size=4).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    t = torch.tensor
    y = (rng.random((3, 4)) < 0.5).astype(np.int32)
    wants = jax.jit(lambda: (
        JNormal(jnp.asarray(loc), jnp.asarray(scale)).log_prob(x),
        JNormal(0.5, 3.0).log_prob(x),
        JMvNormalDiag(jnp.asarray(loc), jnp.asarray(scale)).log_prob(x),
        JBernoulliLogits(jnp.asarray(x)).log_prob(y)))()
    _close(Normal(t(loc), t(scale)).log_prob(t(x)), wants[0])
    _close(Normal(0.5, 3.0).log_prob(t(x)), wants[1])
    _close(MvNormalDiag(t(loc), t(scale)).log_prob(t(x)), wants[2])
    _close(BernoulliLogits(t(x)).log_prob(t(y)), wants[3])
    assert MvNormalDiag(t(loc), t(scale)).shape == (4,)
    assert Normal(t(loc), 1.0).shape == (4,)


def test_uniform_init_strategy_draws_in_the_unconstrained_box():
    tm = tsuite.build("logreg", device="cpu", n=16, dim=3)
    tvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0),
                                 init_strategy="uniform")
    flat = tvi.link().flat()
    assert flat.shape == (4,) and bool(((flat > -2) & (flat < 2)).all())


def test_distribution_samples_have_the_declared_shape():
    gen = torch.Generator().manual_seed(0)
    d = MvNormalDiag(torch.zeros(2, 3), torch.ones(2, 3))
    assert d.sample(gen).shape == (2, 3)
    assert Normal(0.0, 1.0).sample(gen, (5,)).shape == (5,)
    draw = BernoulliLogits(torch.zeros(7)).sample(gen)
    assert draw.dtype == torch.int32 and set(draw.tolist()) <= {0, 1}


# ---------------------------------------------------------------------------
# paper-suite data, typed traces, flat layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_paper_suite_data_equal_bit_for_bit(name):
    want = jsuite.build(name).data  # full Table-1 size
    got = tsuite.build(name, device="cpu").data
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@functools.lru_cache(maxsize=None)
def _pair(name):
    """Both packages' model and trace, made once a module for each model
    (no test changes them: a trace's link and replace return new ones)."""
    jm = jsuite.build(name, **SMALL[name])
    tm = tsuite.build(name, device="cpu", **SMALL[name])
    jtvi = jm.model.typed_varinfo(jax.random.PRNGKey(0))
    ttvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0))
    return jm, tm, jtvi, ttvi


@functools.lru_cache(maxsize=None)
def _jlinked(name):
    """The JAX trace of ``_pair(name)``, linked, once a module."""
    return _pair(name)[2].link()


def _jax_signature(jtvi):
    return tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                 for s in jtvi.layout.sites)


@pytest.mark.parametrize("name", MODELS)
def test_flat_link_roundtrip_and_layout_signature(name):
    _, _, jtvi, ttvi = _pair(name)
    assert layout_signature(ttvi) == _jax_signature(jtvi)
    assert layout_signature(ttvi.link()) == _jax_signature(_jlinked(name))
    for tvi in (ttvi, ttvi.link()):
        flat = tvi.flat()
        assert flat.shape == (tvi.num_flat,)
        torch.testing.assert_close(tvi.replace_flat(flat).flat(), flat,
                                   rtol=0, atol=0)
    linked = ttvi.link()
    for a, b in zip(linked.invlink().values, ttvi.values):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    other = type(ttvi)(ttvi.values, ttvi.dists, ttvi.metas)
    assert other.layout is ttvi.layout  # cached on the trace type


@pytest.mark.parametrize("name", MODELS)
def test_logdensity_value_and_grad_match_jax(name):
    jm, tm, jtvi, ttvi = _pair(name)
    jlinked, tlinked = _jlinked(name), ttvi.link()
    rng = np.random.default_rng(3)
    u = (np.asarray(jlinked.flat())
         + 0.3 * rng.normal(size=jlinked.num_flat)).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(
        jm.model.make_logdensity_fn(jlinked)))(jnp.asarray(u))

    carried = state_from_reference(tlinked, u, _jax_signature(jlinked))
    ut = carried.flat()
    np.testing.assert_array_equal(ut.numpy(), u)
    for backend in ("fused", "reference"):
        f = value_and_grad(tm.model.make_logdensity_fn(tlinked,
                                                       backend=backend))
        v, g = f(ut)
        _close(v, jv, atol=0)
        _grad_close(g, jg)
    # the hand-written twin sees the same layout
    _close(tm.handwritten(ut), jv, atol=0)
    # a chain batch under vmap equals the one-vector evaluation
    f = value_and_grad(tm.model.make_logdensity_fn(tlinked))
    vb, gb = f(torch.stack([ut, ut + 0.1]))
    _close(vb[0], v, rtol=1e-6, atol=0)
    _close(gb[0], g, rtol=1e-6, atol=1e-6 * float(g.abs().max()))


@pytest.mark.parametrize("name", MODELS)
def test_logjoint_fused_matches_reference_and_decomposes(name):
    _, tm, _, ttvi = _pair(name)
    m = tm.model
    joint = float(m.logjoint(ttvi))
    _close(joint, float(m.logjoint(ttvi, backend="reference")), atol=0)
    _close(float(m.logprior(ttvi)) + float(m.loglikelihood(ttvi)), joint,
           atol=0)


def test_model_names_and_builders_match_jax():
    assert tsuite.MODEL_NAMES == jsuite.MODEL_NAMES
    assert sorted(tsuite._BUILDERS) == sorted(jsuite._BUILDERS)


@functools.lru_cache(maxsize=None)
def _sto_volatility_full():
    """Both packages' sto_volatility at Table 1's T = 500, the JAX linked
    trace and its density's value and gradient compiled once, for every
    phi (the same shapes)."""
    jm = jsuite.build("sto_volatility")
    tm = tsuite.build("sto_volatility", device="cpu")
    jlinked = _jax_trace(jm.model, link=True)
    jvg = jax.jit(jax.value_and_grad(jm.model.make_logdensity_fn(jlinked)))
    return jm, tm, jlinked, jvg


@pytest.mark.parametrize("phi", [-0.95, 0.0, 0.5, 0.99])
def test_sto_volatility_ar1_path_matches_the_jax_scan(phi):
    """The closed-form AR(1) path (one power matrix, one product) against
    the JAX package's 499-step ``lax.scan`` at Table 1's T = 500: density
    at rtol 1e-5, gradient at rtol 1e-5 plus atol 1e-5 * max|g|."""
    jm, tm, jlinked, jvg = _sto_volatility_full()
    rng = np.random.default_rng(int(1000 * phi) % 97)
    u = (0.5 * rng.normal(size=jlinked.num_flat)).astype(np.float32)
    p = (phi + 1.0) / 2.0
    u[0] = np.log(p) - np.log1p(-p)  # phi = -1 + 2 sigmoid(u_phi)
    u[1] = np.log(0.3)               # sigma
    jv, jg = jvg(jnp.asarray(u))
    tlinked = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    ut = torch.tensor(u)
    assert abs(float(tlinked.replace_flat(ut).invlink().values[0]) - phi) < 1e-6
    for backend in ("fused", "reference"):
        v, g = value_and_grad(tm.model.make_logdensity_fn(
            tlinked, backend=backend))(ut)
        _close(v, jv, atol=0)
        _grad_close(g, jg)
    _close(tm.handwritten(ut), jv, atol=0)
    _grad_close(torch.func.grad(tm.handwritten)(ut), jg)


def test_gauss_unknown_switch_route_equals_the_fused_route():
    """``backend="reference"`` inside ``use_fused_logpdf()`` sends the
    10,000 observations through ``normal_logpdf_sum`` (its plain version on
    the CPU); value and gradient equal the fused backend's, and the JAX
    package's with its switch on (Pallas in interpret mode)."""
    import repro.kernels as jk
    from repro_torch import kernels as tk

    jm, tm = jsuite.build("gauss_unknown"), tsuite.build("gauss_unknown",
                                                         device="cpu")
    jlinked = _jax_trace(jm.model, link=True)
    tlinked = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    u = np.array([0.1, 1.4], np.float32)
    with jk.use_fused_logpdf():
        jv, jg = jax.jit(jax.value_and_grad(jm.model.make_logdensity_fn(
            jlinked, backend="reference")))(jnp.asarray(u))
    fused = value_and_grad(tm.model.make_logdensity_fn(tlinked))
    switched = value_and_grad(tm.model.make_logdensity_fn(
        tlinked, backend="reference"))
    batch = torch.tensor(np.stack([u, u + 0.2]))
    with tk.use_fused_logpdf():
        v, g = switched(torch.tensor(u))
        vb, gb = switched(batch)
    _close(v, jv, atol=0)
    _grad_close(g, jg)
    fv, fg = fused(batch)
    _close(vb, fv, atol=0)
    _grad_close(gb, fg)


def test_state_from_reference_rejects_other_layouts():
    _, _, jtvi, ttvi = _pair("logreg")
    linked = ttvi.link()
    sig = _jax_signature(_jlinked("logreg"))
    bad = tuple((n + "_x", s, o, k) for n, s, o, k in sig)
    with pytest.raises(ValueError, match="layouts differ"):
        state_from_reference(linked, np.zeros(linked.num_flat), bad)
    with pytest.raises(ValueError, match="shape"):
        state_from_reference(linked, np.zeros(linked.num_flat + 1), sig)


# ---------------------------------------------------------------------------
# entry points and package hygiene
# ---------------------------------------------------------------------------
def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(_device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsuite.build("logreg", n=8, dim=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.resolve_device(None)
    assert _device.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    # every builder of the JAX package is ported: an unknown name raises
    # the KeyError the JAX package's build raises
    with pytest.raises(KeyError):
        jsuite.build("no_such_model")
    with pytest.raises(KeyError):
        tsuite.build("no_such_model", device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


# ---------------------------------------------------------------------------
# the reference's public names on Model, the evaluators and TypedVarInfo
# ---------------------------------------------------------------------------
UNTYPED = ("logreg", "hier_poisson", "gauss_unknown")


def _constrained(jtvi):
    """The JAX trace's constrained values as NumPy, by site name."""
    return {k: np.array(v) for k, v in jtvi.as_dict().items()}


@pytest.mark.parametrize("name", UNTYPED)
def test_logjoint_untyped_matches_jax(name):
    jm, tm, jtvi, _ = _pair(name)
    vals = _constrained(jtvi)
    want = jm.model.logjoint_untyped({k: jnp.asarray(v)
                                      for k, v in vals.items()})
    got = tm.model.logjoint_untyped({k: torch.as_tensor(v)
                                     for k, v in vals.items()})
    assert isinstance(got, float)
    _close(got, want, atol=0)
    # the eager path agrees with the typed one on the same values
    carried = state_from_reference(
        tm.model.typed_varinfo(torch.Generator().manual_seed(0)),
        np.concatenate([v.reshape(-1) for v in vals.values()]),
        tuple((s.name, tuple(s.shape), s.offset, s.size)
              for s in jtvi.layout.sites))
    _close(got, float(tm.model.logjoint(carried)), atol=0)


@pytest.mark.parametrize("name", UNTYPED)
def test_bind_replaces_data_as_jax_does(name):
    jm, tm, jtvi, _ = _pair(name)
    key = next(k for k, v in tm.model.data.items()
               if torch.is_tensor(v) and v.dtype.is_floating_point)
    old = tm.model.data[key]
    new = np.asarray(old.numpy() * 0.5 + 0.25, dtype=old.numpy().dtype)
    tb_ = tm.model.bind(**{key: torch.as_tensor(new)})
    jb_ = jm.model.bind(**{key: jnp.asarray(new)})
    assert tb_ is not tm.model and tb_.gen is tm.model.gen
    assert tm.model.data[key] is old  # the bound model is left as it was
    assert set(tb_.data) == set(tm.model.data)
    vals = _constrained(jtvi)
    _close(tb_.logjoint_untyped({k: torch.as_tensor(v)
                                 for k, v in vals.items()}),
           jb_.logjoint_untyped({k: jnp.asarray(v) for k, v in vals.items()}),
           atol=0)


@pytest.mark.parametrize("name", UNTYPED)
def test_sample_prior_matches_jax_support_and_shapes(name):
    jm, tm, _, _ = _pair(name)
    want = jm.model.sample_prior(jax.random.PRNGKey(1))
    got = tm.model.sample_prior(1)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k]))
        assert bool(torch.isfinite(got[k]).all())
    same = tm.model.sample_prior(torch.Generator().manual_seed(1))
    for k in got:
        torch.testing.assert_close(same[k], got[k], rtol=0, atol=0)
    # every draw lies in its site's support: its density is finite
    assert np.isfinite(tm.model.logjoint_untyped(got))


def test_eager_reject_short_circuits_as_in_jax():
    from repro.core import model as jmodel, reject_if as jreject_if
    from repro.core.contexts import DefaultContext as JDefault
    from repro_torch import model as tmodel, reject, reject_if, sample
    from repro_torch.core.contexts import DefaultContext
    from repro_torch.core.interpreters import Evaluator, LinkedEvaluator
    hits = []

    @tmodel
    def guarded():
        x = sample("x", Normal(0.0, 1.0))
        reject_if(x < 10.0)  # always rejects
        hits.append(1)

    @tmodel
    def plain_reject():
        sample("x", Normal(0.0, 1.0))
        reject()
        hits.append(1)

    @jmodel
    def jguarded():
        from repro import sample as jsample
        x = jsample("x", JNormal(0.0, 1.0))
        jreject_if(x < 10.0)

    for gen in (guarded, plain_reject):
        m = gen()
        tvi = m.typed_varinfo(torch.Generator().manual_seed(7))
        n0 = len(hits)
        assert np.isneginf(m.logjoint_untyped({"x": torch.tensor(0.3)}))
        for values in (tvi, tvi.link()):
            assert np.isneginf(float(m._eval_logp(values, DefaultContext(),
                                                  eager=True)))
        assert len(hits) == n0  # the body after the guard never ran
    jm = jguarded()
    assert np.isneginf(jm.logjoint_untyped({"x": jnp.asarray(0.3)}))
    jtvi = jm.typed_varinfo(jax.random.PRNGKey(7)).link()
    assert np.isneginf(float(jm._eval_logp(jtvi, JDefault(), eager=True)))
    # replay without eager masks instead of raising, as in the reference
    m = guarded()
    tvi = m.typed_varinfo(torch.Generator().manual_seed(7)).link()
    assert np.isneginf(float(m.logjoint(tvi, backend="reference")))
    assert Evaluator({}, eager=True).eager and not Evaluator({}).eager
    assert LinkedEvaluator(tvi, eager=True).eager
    assert not LinkedEvaluator(tvi).eager


@pytest.mark.parametrize("name", ("hier_poisson", "gauss_unknown"))
def test_typed_varinfo_site_accessors_match_jax(name):
    jm, tm, jtvi, ttvi = _pair(name)
    jlinked = _jlinked(name)
    sig = _jax_signature(jlinked)
    tlinked = state_from_reference(ttvi.link(), np.asarray(jlinked.flat()),
                                   sig)
    for m in jlinked.metas:
        np.testing.assert_allclose(tlinked.raw_value(m.name).numpy(),
                                   np.asarray(jlinked.raw_value(m.name)),
                                   rtol=0, atol=0)
        assert type(tlinked.dist_of(m.name)).__name__ == \
            type(jlinked.dist_of(m.name)).__name__
        assert m.name in tlinked
    first = jlinked.metas[0].name
    shift = np.asarray(jlinked.raw_value(first)) + np.float32(0.2)
    jsite = jlinked.replace_site(first, jnp.asarray(shift))
    tsite = tlinked.replace_site(first, torch.as_tensor(shift))
    assert tsite.linked and tsite.layout is tlinked.layout
    _close(float(tm.model.logjoint(tsite)), float(jm.model.logjoint(jsite)),
           atol=0)
    tvals = tlinked.replace_values(tsite.values)
    torch.testing.assert_close(tvals.flat(), tsite.flat(), rtol=0, atol=0)
    assert tlinked.raw_value(first) is not tsite.raw_value(first)


def test_gauss_unknown_mixing_at_table1_step_matches_jax(capsys):
    """gauss_unknown at Table 1's size and fixed step (0.01, 4 leapfrog
    steps, 4 chains) from the data's moments, each package's own density,
    gradient and integrator fed the same momentum and accept draws (NumPy):
    the chains and m's ESS agree, so a low ESS there is Table 1's setting,
    not the port."""
    from repro.infer import chains as jchains
    from repro.infer import hmc as jhmc
    from repro_torch.infer import chains as tchains
    from repro_torch.infer import hmc as thmc
    jm = jsuite.build("gauss_unknown")
    tm = tsuite.build("gauss_unknown", device="cpu")
    y = np.asarray(jm.data["y"], np.float64)
    start = (np.float32(y.var()), np.float32(y.mean()))  # (s, m)
    jtvi = _jax_trace(jm.model)
    jlinked = jtvi.replace_values(tuple(jnp.asarray(v) for v in start)).link()
    ttvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0))
    tlinked = ttvi.replace_values(tuple(torch.tensor(v) for v in start)).link()
    np.testing.assert_allclose(tlinked.flat().numpy(),
                               np.asarray(jlinked.flat()), rtol=1e-6)
    chains, draws, step, n_lf = 4, 200, tm.step_size, tm.n_leapfrog
    assert (step, n_lf) == (jm.step_size, jm.n_leapfrog) == (0.01, 4)
    rng = np.random.default_rng(5)
    q0 = (np.asarray(jlinked.flat())[None]
          + 0.05 * rng.uniform(-1, 1, (chains, 2))).astype(np.float32)
    noise = rng.standard_normal((draws, chains, 2)).astype(np.float32)
    log_u = np.log(rng.uniform(size=(draws, chains)))

    jf = jax.jit(jax.vmap(jax.value_and_grad(
        jm.model.make_logdensity_fn(jlinked))))
    jlf = jax.jit(jax.vmap(lambda q, p, g: jhmc._leapfrog(
        jax.value_and_grad(jm.model.make_logdensity_fn(jlinked)), q, p, g,
        step, n_lf)))
    tf = thmc.value_and_grad(tm.model.make_logdensity_fn(tlinked))

    def run(init, leapfrog):
        q, (lp, g) = q0, init(q0)
        out = np.empty((draws, chains, 2), np.float64)
        for t in range(draws):
            p0 = noise[t]
            qn, pn, lpn, gn = leapfrog(q, p0, g)
            delta = (-lp + 0.5 * (p0.astype(np.float64) ** 2).sum(-1)) - (
                -lpn + 0.5 * (pn.astype(np.float64) ** 2).sum(-1))
            acc = log_u[t] < np.minimum(0.0, np.nan_to_num(delta, nan=-np.inf))
            q = np.where(acc[:, None], qn, q)
            lp, g = np.where(acc, lpn, lp), np.where(acc[:, None], gn, g)
            out[t] = q
        return out

    def jax_leapfrog(q, p, g):
        qn, pn, lpn, gn = jlf(jnp.asarray(q), jnp.asarray(p), jnp.asarray(g))
        return tuple(np.asarray(a) for a in (qn, pn, lpn, gn))

    def torch_leapfrog(q, p, g):
        with torch.no_grad():
            out = thmc._leapfrog(tf, torch.as_tensor(q), torch.as_tensor(p),
                                 torch.as_tensor(g), step, n_lf)
        return tuple(a.numpy() for a in out)

    jdraws = run(lambda q: tuple(np.asarray(a) for a in jf(jnp.asarray(q))),
                 jax_leapfrog)
    tdraws = run(lambda q: tuple(a.detach().numpy()
                                 for a in tf(torch.as_tensor(q))),
                 torch_leapfrog)
    m_j, m_t = jdraws[..., 1].T, tdraws[..., 1].T  # (chains, draws)
    ess_j = jchains.effective_sample_size(m_j)
    ess_t = tchains.effective_sample_size(m_t)
    with capsys.disabled():
        print(f"\ngauss_unknown m, {chains} x {draws} draws at step {step}: "
              f"ESS {ess_t:.1f} (port) vs {ess_j:.1f} (JAX package); max "
              f"|draw difference| {np.abs(tdraws - jdraws).max():.2e}")
    # the same draws move both chains alike (float32 rounding may flip a
    # borderline accept now and then, and the chain runs apart for a
    # stretch before it re-joins), so the ESS agree closely
    close = np.abs(tdraws - jdraws).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.75, close.mean()
    assert abs(ess_t - ess_j) <= 0.1 * ess_j
