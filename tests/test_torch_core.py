"""PyTorch port: bijectors, distributions, typed traces and the fused flat
log-density, held against the JAX package on the same NumPy inputs.

Models are the paper's ``logreg``, ``naive_bayes``, ``hier_poisson``,
``hmm_semisup``, ``lda``, ``gauss_unknown``, ``sto_volatility`` and
``eight_schools`` at small size; the data come from the same
``np.random.default_rng`` calls in both packages.
Tolerances: value rtol 1e-5; gradient rtol 1e-5 with atol 1e-5 * max|g|
(float32, sums in another order). TF32 is off (``resolve_device``).
"""
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

REPO = Path(__file__).resolve().parents[1]
SMALL = {"logreg": dict(n=256, dim=8),
         "naive_bayes": dict(n=64, n_classes=3, dim=4),
         "hier_poisson": dict(n=20, n_groups=4),
         "hmm_semisup": dict(K=3, V=6, T=30, T_sup=10),
         "lda": dict(V=12, K=3, D=4, avg_len=30),
         "gauss_unknown": dict(n=64),
         "sto_volatility": dict(T=40),
         "eight_schools": {}}
MODELS = list(SMALL)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=1e-5, atol=1e-5 * float(np.max(np.abs(want))))


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
    xt, xj = torch.tensor(x), jnp.asarray(x)
    y = tbij.forward(xt)
    _close(y, jbij.forward(xj))
    _close(tbij.forward_log_det_jacobian(xt), jbij.forward_log_det_jacobian(xj))
    _close(tbij.inverse(y), jbij.inverse(jbij.forward(xj)), atol=1e-5)
    assert tuple(y.shape) == tuple(jbij.forward(xj).shape)
    assert tbij.unconstrained_shape(y.shape) == \
        jbij.unconstrained_shape(tuple(y.shape))


def test_distributions_log_prob_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    loc = rng.normal(size=4).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    t = torch.tensor
    _close(Normal(t(loc), t(scale)).log_prob(t(x)),
           JNormal(jnp.asarray(loc), jnp.asarray(scale)).log_prob(x))
    _close(Normal(0.5, 3.0).log_prob(t(x)), JNormal(0.5, 3.0).log_prob(x))
    _close(MvNormalDiag(t(loc), t(scale)).log_prob(t(x)),
           JMvNormalDiag(jnp.asarray(loc), jnp.asarray(scale)).log_prob(x))
    y = (rng.random((3, 4)) < 0.5).astype(np.int32)
    _close(BernoulliLogits(t(x)).log_prob(t(y)),
           JBernoulliLogits(jnp.asarray(x)).log_prob(y))
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


def _pair(name):
    jm = jsuite.build(name, **SMALL[name])
    tm = tsuite.build(name, device="cpu", **SMALL[name])
    jtvi = jm.model.typed_varinfo(jax.random.PRNGKey(0))
    ttvi = tm.model.typed_varinfo(torch.Generator().manual_seed(0))
    return jm, tm, jtvi, ttvi


def _jax_signature(jtvi):
    return tuple((s.name, tuple(s.shape), s.unc_offset, s.unc_size)
                 for s in jtvi.layout.sites)


@pytest.mark.parametrize("name", MODELS)
def test_flat_link_roundtrip_and_layout_signature(name):
    _, _, jtvi, ttvi = _pair(name)
    assert layout_signature(ttvi) == _jax_signature(jtvi)
    assert layout_signature(ttvi.link()) == _jax_signature(jtvi.link())
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
    jlinked, tlinked = jtvi.link(), ttvi.link()
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


@pytest.mark.parametrize("phi", [-0.95, 0.0, 0.5, 0.99])
def test_sto_volatility_ar1_path_matches_the_jax_scan(phi):
    """The closed-form AR(1) path (one power matrix, one product) against
    the JAX package's 499-step ``lax.scan`` at Table 1's T = 500: density
    at rtol 1e-5, gradient at rtol 1e-5 plus atol 1e-5 * max|g|."""
    jm = jsuite.build("sto_volatility")
    tm = tsuite.build("sto_volatility", device="cpu")
    jlinked = jm.model.typed_varinfo(jax.random.PRNGKey(0)).link()
    rng = np.random.default_rng(int(1000 * phi) % 97)
    u = (0.5 * rng.normal(size=jlinked.num_flat)).astype(np.float32)
    p = (phi + 1.0) / 2.0
    u[0] = np.log(p) - np.log1p(-p)  # phi = -1 + 2 sigmoid(u_phi)
    u[1] = np.log(0.3)               # sigma
    jv, jg = jax.jit(jax.value_and_grad(
        jm.model.make_logdensity_fn(jlinked)))(jnp.asarray(u))
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
    jlinked = jm.model.typed_varinfo(jax.random.PRNGKey(0)).link()
    tlinked = tm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    u = np.array([0.1, 1.4], np.float32)
    with jk.use_fused_logpdf():
        jv, jg = jax.value_and_grad(jm.model.make_logdensity_fn(
            jlinked, backend="reference"))(jnp.asarray(u))
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
    sig = _jax_signature(jtvi.link())
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
