"""PyTorch port: the fused leapfrog and fused potential against the JAX
package, and the fused integrator against the autodiff one.

Specs are compiled by ``repro`` (every opcode in one table, and each
opcode alone as its sites' coordinates of that table) and carried across
with ``spec_from_reference``; states are made with NumPy from a
seed. The port's wrappers run their plain versions on the CPU; the JAX
side runs its plain reference (``use_pallas=False``, the jnp oracle that
the JAX package's own tests hold its Pallas kernels to), every chain with
its own step size in one compiled program. Tolerances are those of
``tests/test_fused_leapfrog.py``:
max abs 1e-5 on q and p, 1e-4 on the gradient, and 1e-5 on
``|logp - ref| / (1 + |ref|)``. The CUDA kernels themselves run only on a
GPU: ``test_torch_kernels_cuda.py`` holds them.

The conditional integrator (a ``CondPotentialSpec`` from each package's
own compiler, at the same state) is held to ``repro``'s
``leapfrog_cond_ref`` over 8 steps at 1e-5, and one HMC transition with
the same NumPy momentum and accept uniform on eight_schools and on
gauss_unknown at 200 observations.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.potential import build_potential_spec as jbuild_spec
from repro.dists import (Beta, Cauchy, Exponential, Flat, Gamma, HalfNormal,
                         LogNormal, Normal, StudentT, Uniform)
from repro.kernels import fused_leapfrog as jfl
from repro.kernels.fused_leapfrog import PotentialSpec as JPotentialSpec
from repro.infer import hmc as jhmc
from repro.kernels.fused_leapfrog import ref as jfl_ref
from repro.models import paper_suite as jsuite
from repro_torch.convert import (layout_signature, spec_from_reference,
                                 state_from_reference)
from repro_torch.core.potential import compile_potential
from repro_torch.infer import HMC, run_chains
from repro_torch.infer.hmc import _leapfrog, hmc_transition, value_and_grad
from repro_torch.kernels.fused_leapfrog import (LAUNCHES, OP_EXP, OP_NORMAL,
                                                OP_SOFTPLUS, OP_TLOG, OP_ZERO,
                                                fused_leapfrog,
                                                potential_value_and_grad)
from repro_torch.kernels.fused_leapfrog import ops as lf_ops
from repro_torch.kernels.fused_leapfrog import ref as lf_ref
from repro_torch.models import paper_suite as tsuite
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


TOL = 1e-5
EPS = np.array([0.05, 0.03, 0.08], np.float32)  # one step size per chain


def _sites():
    """Sites of every opcode family (ZERO is the Flat site)."""
    repro.sample("n", Normal(jnp.zeros(8), 2.0))
    repro.sample("l", LogNormal(0.5, 1.2))
    repro.sample("g", Gamma(2.0 * jnp.ones(5), 1.5))
    repro.sample("h", HalfNormal(0.5))
    repro.sample("e", Exponential(0.7 * jnp.ones(2)))
    repro.sample("b", Beta(2.0, 3.0))
    repro.sample("u", Uniform(-1.0, 2.0))
    repro.sample("t", StudentT(4.0, 0.0, jnp.ones(3)))
    repro.sample("c", Cauchy(0.0, 2.0))
    repro.sample("f", Flat(jnp.zeros(4)))


KINDS = {"mix": None, "zero": OP_ZERO, "normal": OP_NORMAL, "exp": OP_EXP,
         "softplus": OP_SOFTPLUS, "tlog": OP_TLOG}


# each kind's sites: one opcode throughout ("mix" is every site)
KIND_SITES = {"zero": ("f",), "normal": ("n", "l"), "exp": ("g", "h", "e"),
              "softplus": ("b", "u"), "tlog": ("t", "c")}


@functools.lru_cache(maxsize=None)
def _mix_spec():
    """``repro``'s spec of every site in one table, and its linked trace:
    the prior draw, and the compiler's value and gradient probes, each
    compiled as one program (as the JAX package's samplers run them)."""
    @repro.model
    def family_mix():
        _sites()

    m = family_mix()
    tvi = jax.jit(lambda key: m.typed_varinfo(key).link())(
        jax.random.PRNGKey(0))
    make = m.make_logdensity_fn
    m.make_logdensity_fn = lambda *a, **k: jax.jit(make(*a, **k))
    return jbuild_spec(m, tvi, backend="fused"), tvi


@pytest.fixture(scope="module", params=list(KINDS))
def spec_pair(request):
    """A spec compiled by ``repro`` and the port's copy of it: for "mix"
    the whole table, for each other kind the coordinates of its sites in
    that table (their opcodes and coefficients as ``repro`` compiled
    them, and the table's const), so ``repro``'s compiler runs once."""
    kind = request.param
    js, tvi = _mix_spec()
    u0 = np.asarray(tvi.flat(), np.float32)
    if kind != "mix":
        idx = np.concatenate([
            np.arange(s.unc_offset, s.unc_offset + s.unc_size)
            for s in tvi.layout.sites if s.name in KIND_SITES[kind]])
        js = JPotentialSpec(js.op[idx], js.c0[idx], js.c1[idx], js.c2[idx],
                            js.c3[idx], js.const, int(idx.size))
        u0 = u0[idx]
    assert js.uniform_op == KINDS[kind]
    ts = spec_from_reference(js.op, js.c0, js.c1, js.c2, js.c3, js.const,
                             js.dim)
    assert ts.uniform_op == js.uniform_op
    return js, ts, u0


def _states(u0, seed=7):
    rng = np.random.default_rng(seed)
    q = (u0[None] + 0.2 * rng.normal(size=(len(EPS), u0.size))) \
        .astype(np.float32)
    p = rng.normal(size=q.shape).astype(np.float32)
    return q, p, rng


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b):
    return abs(float(a) - float(b)) / (1.0 + abs(float(b)))


@pytest.mark.parametrize("metric", ["unit", "diag"])
def test_fused_leapfrog_matches_jax_pallas_kernel(spec_pair, metric):
    """The port's fused_leapfrog (its plain version here) against the JAX
    package's fused_leapfrog through its plain reference, 8 steps, each
    chain at its own step size."""
    js, ts, u0 = spec_pair
    q, p, rng = _states(u0)
    im = (None if metric == "unit"
          else rng.uniform(0.5, 1.5, size=u0.size).astype(np.float32))
    _, g = potential_value_and_grad(ts, torch.tensor(q))
    g = g.numpy()
    before = dict(LAUNCHES)
    got = fused_leapfrog(ts, torch.tensor(q), torch.tensor(p),
                         torch.tensor(g), torch.tensor(EPS), 8,
                         inv_mass=None if im is None else torch.tensor(im))
    assert LAUNCHES == before  # the CPU path runs the plain version
    jim = None if im is None else jnp.asarray(im)
    wants = jax.jit(jax.vmap(lambda q, p, g, e: jfl.fused_leapfrog(
        js, q, p, g, e, 8, inv_mass=jim, use_pallas=False)))(
        *map(jnp.asarray, (q, p, g, EPS)))
    for c in range(len(EPS)):
        wq, wp, wlp, wg = (w[c] for w in wants)
        assert _max_abs(got[0][c], wq) < TOL
        assert _max_abs(got[1][c], wp) < TOL
        assert _rel(got[2][c], wlp) < TOL
        assert _max_abs(got[3][c], wg) < 1e-4


def test_potential_value_and_grad_matches_jax_pallas_kernel(spec_pair):
    """The port's potential value and gradient against the JAX package's
    plain reference, every chain in one compiled program."""
    js, ts, u0 = spec_pair
    q, _, _ = _states(u0, seed=11)
    logp, g = potential_value_and_grad(ts, torch.tensor(q))
    assert logp.shape == (len(EPS),) and g.shape == q.shape
    wlps, wgs = jax.jit(jax.vmap(lambda u: jfl.potential_value_and_grad(
        js, u, use_pallas=False)))(jnp.asarray(q))
    for c in range(len(EPS)):
        assert _rel(logp[c], wlps[c]) < TOL
        assert _max_abs(g[c], wgs[c]) < TOL
    # one chain as a (dim,) vector gives the same numbers
    lp1, g1 = potential_value_and_grad(ts, torch.tensor(q[1]))
    assert lp1.shape == () and float(lp1) == float(logp[1])
    torch.testing.assert_close(g1, g[1], rtol=0, atol=0)


def test_wrappers_check_their_inputs(spec_pair):
    _, ts, u0 = spec_pair
    q = torch.tensor(u0)
    with pytest.raises(ValueError, match="expected a state of shape"):
        potential_value_and_grad(ts, torch.zeros(ts.dim + 1))
    with pytest.raises(TypeError, match="float32"):
        fused_leapfrog(ts, q, q.double(), q, 0.1, 2)
    with pytest.raises(ValueError, match="inv_mass"):
        fused_leapfrog(ts, q, q, q, 0.1, 2,
                       inv_mass=torch.ones(ts.dim + 1))
    with pytest.raises(ValueError, match="n_steps"):
        fused_leapfrog(ts, q, q, q, 0.1, -1)


# ---------------------------------------------------------------------------
# the fused integrator against the autodiff one, inside the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gaussian():
    pm = tsuite.build("gaussian_10k", device="cpu", dim=64)
    tvi = pm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    res = compile_potential(pm.model, tvi)
    assert res.kind == "separable" and res.spec.uniform_op == OP_NORMAL
    return pm, tvi, res.spec


@pytest.mark.parametrize("metric", ["unit", "diag"])
def test_gaussian_trajectories_fused_match_autodiff(gaussian, metric):
    pm, tvi, spec = gaussian
    q, p, rng = _states(tvi.flat().numpy())
    im = (None if metric == "unit"
          else torch.tensor(rng.uniform(0.5, 2.0, size=q.shape[1])
                            .astype(np.float32)))
    ldg = value_and_grad(pm.model.make_logdensity_fn(tvi))
    qt, pt = torch.tensor(q), torch.tensor(p)
    logp0, g0 = ldg(qt)
    flp0, fg0 = potential_value_and_grad(spec, qt)
    assert _max_abs(fg0, g0) < TOL
    assert max(_rel(a, b) for a, b in zip(flp0, logp0)) < TOL
    eps = torch.tensor(EPS)
    want = _leapfrog(ldg, qt, pt, g0, eps, 4, inv_mass=im)
    got = fused_leapfrog(spec, qt, pt, g0, eps, 4, inv_mass=im)
    for name, tol in (("q", TOL), ("p", TOL), ("grad", 1e-4)):
        i = {"q": 0, "p": 1, "grad": 3}[name]
        assert _max_abs(got[i], want[i]) < tol, name
    assert max(_rel(a, b) for a, b in zip(got[2], want[2])) < TOL


def test_gaussian_transition_fused_matches_autodiff(gaussian):
    """One MH-corrected transition for 3 chains, same generator seed."""
    pm, tvi, spec = gaussian
    q, _, _ = _states(tvi.flat().numpy())
    qt = torch.tensor(q)
    ldg = value_and_grad(pm.model.make_logdensity_fn(tvi))
    logp, grad = ldg(qt)

    def fused_lf(q, p, g, eps, n):
        return fused_leapfrog(spec, q, p, g, eps, n)

    eps = torch.tensor(EPS)
    r = hmc_transition(ldg, qt, logp, grad, eps,
                       torch.Generator().manual_seed(21), 8)
    f = hmc_transition(lambda u: potential_value_and_grad(spec, u), qt,
                       logp, grad, eps, torch.Generator().manual_seed(21), 8,
                       leapfrog_fn=fused_lf)
    for rv, fv in zip(r[:3], f[:3]):
        assert _max_abs(rv, fv) < 1e-4
    torch.testing.assert_close(f[4], r[4], rtol=0, atol=0)  # accepted


def test_run_chains_auto_runs_fused_and_matches_reference():
    pm = tsuite.build("gaussian_10k", device="cpu", dim=64)
    auto = HMC(step_size=pm.step_size, n_leapfrog=4)
    assert auto.uses_potential_spec
    assert not HMC(leapfrog="reference").uses_potential_spec
    ch_f = run_chains(2, pm.model, auto, 40, num_warmup=10, num_chains=3,
                      device="cpu")
    ch_r = run_chains(2, pm.model, HMC(step_size=pm.step_size, n_leapfrog=4,
                                       leapfrog="reference"),
                      40, num_warmup=10, num_chains=3, device="cpu")
    assert _max_abs(ch_f["x"], ch_r["x"]) < 1e-4
    assert _max_abs(ch_f.stats["logp"], ch_r.stats["logp"]) < 1e-3
    ch = run_chains(2, pm.model, HMC(step_size=0.1, leapfrog="fused",
                                     inv_mass=np.full(64, 0.5, np.float32),
                                     adapt_step_size=True),
                    5, num_warmup=5, num_chains=2, device="cpu")
    assert np.isfinite(ch["x"]).all()


@pytest.mark.parametrize("switch", [dict(use_pallas=False),
                                    dict(interpret=True, block_rows=64)])
def test_wrappers_take_the_jax_switches(spec_pair, switch, monkeypatch):
    """``use_pallas=False`` or ``interpret=True`` runs the plain version
    even where the kernel would launch (a CUDA tensor, stood in for here
    by the device check), equal to the JAX package's; ``block_rows`` is
    accepted and ignored; the default takes the kernel route."""
    from repro_torch.kernels.fused_leapfrog import ops as lf_ops
    js, ts, u0 = spec_pair
    q, p, _ = _states(u0, seed=13)
    _, g = potential_value_and_grad(ts, torch.tensor(q))

    def no_kernel():
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(lf_ops, "_device_kind", lambda *ts_: "cuda")
    monkeypatch.setattr(lf_ops, "_lib", no_kernel)
    before = dict(LAUNCHES)
    lp, gg = potential_value_and_grad(ts, torch.tensor(q[0]), **switch)
    out = fused_leapfrog(ts, torch.tensor(q[0]), torch.tensor(p[0]), g[0],
                         float(EPS[0]), 4, **switch)
    assert LAUNCHES == before
    (wlp, wg), want = jax.jit(lambda q, p, g: (
        jfl.potential_value_and_grad(js, q, use_pallas=False),
        jfl.fused_leapfrog(js, q, p, g, float(EPS[0]), 4,
                           use_pallas=False)))(
        jnp.asarray(q[0]), jnp.asarray(p[0]), jnp.asarray(g[0].numpy()))
    assert _rel(lp, wlp) < TOL and _max_abs(gg, wg) < TOL
    assert _max_abs(out[0], want[0]) < TOL and _rel(out[2], want[2]) < TOL
    # the default takes the kernel route, which cannot run on this tensor
    with pytest.raises((AssertionError, ValueError, RuntimeError)):
        potential_value_and_grad(ts, torch.tensor(q[0]))


# ---------------------------------------------------------------------------
# the one-launch kernel's plan, as the card's wrapper takes it (pure Python)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim,nparts", [
    (1, 1), (lf_ops.LEAPFROG_SHARE, 1), (lf_ops.LEAPFROG_SHARE + 1, 2),
    (8192, 32), (10_000, 40), (1_000_003, 3907)])
def test_leapfrog_parts_from_dim_alone(dim, nparts):
    """One block a chain up to the share (it writes the chain's potential
    itself), then one block per 256 coordinates whose last merges."""
    assert lf_ops.leapfrog_parts(dim) == nparts


def test_eps_arg_reads_numbers_and_tensors_without_copies():
    """The step size as the kernel reads it: a number by value, a 0-d
    tensor at stride 0, a per-chain vector at its own stride (no copy);
    another shape raises."""
    assert lf_ops._eps_arg(0.1, 4, torch.device("cpu"))[:3] == (
        None, 0, pytest.approx(0.1))
    one = torch.tensor(0.1)
    assert lf_ops._eps_arg(one, 4, one.device)[:2] == (one.data_ptr(), 0)
    per = torch.rand(8)[::2]  # a strided (4,) view
    addr, stride, _, keep = lf_ops._eps_arg(per, 4, per.device)
    assert (addr, stride) == (per.data_ptr(), 2) and keep is per
    addr, _, _, keep = lf_ops._eps_arg(per.double(), 4, per.device)
    assert keep.dtype == torch.float32 and addr == keep.data_ptr()
    with pytest.raises(ValueError, match="step_size"):
        lf_ops._eps_arg(torch.rand(3), 4, torch.device("cpu"))


def test_random_spec_runs_keep_one_opcode_a_run():
    """``run=512`` lays out family_mix_8k's mixed table: one opcode for
    each 512 coordinates; ``run=1`` draws as before, one a coordinate."""
    spec = lf_ref.random_spec(8192, None, seed=3, run=512)
    runs = spec.op.reshape(16, 512)
    assert (runs == runs[:, :1]).all() and spec.uniform_op is None
    np.testing.assert_array_equal(lf_ref.random_spec(100, None, seed=3).op,
                                  np.random.default_rng(3).integers(0, 5, 100))


# ---------------------------------------------------------------------------
# the conditional integrator against the JAX package's
# ---------------------------------------------------------------------------
COND_MODELS = {"eight_schools": {}, "gauss_unknown": dict(n=200)}


@functools.lru_cache(maxsize=None)
def _cond_pair(name):
    """Both packages' conditional specs of one model, each from its own
    compiler at the JAX trace's state, with the state."""
    from repro.core.potential import compile_potential as jcompile

    jm = jsuite.build(name, **COND_MODELS[name]).model
    make = jm.make_logdensity_fn
    jm.make_logdensity_fn = lambda *a, **k: jax.jit(make(*a, **k))
    jtvi = jm.typed_varinfo(jax.random.PRNGKey(0)).link()
    pm = tsuite.build(name, device="cpu", **COND_MODELS[name])
    ttvi = pm.model.typed_varinfo(torch.Generator().manual_seed(0)).link()
    ttvi = state_from_reference(ttvi, np.array(jtvi.flat()),
                                layout_signature(jtvi))
    jres, tres = jcompile(jm, jtvi), compile_potential(pm.model, ttvi)
    assert jres.kind == tres.kind == "conditional"
    return jres.spec, tres.spec, ttvi.flat().numpy(), pm


def test_cond_leapfrog_matches_the_reference_trajectory():
    """8 steps of ``leapfrog_cond_ref`` from the same NumPy state and
    momentum (``repro``'s ``test_cond_leapfrog_matches_autodiff_trajectory``
    setting: step 0.1), q, p and the final potential at 1e-5; one chain
    as a ``(dim,)`` vector and as a batch of one, launching nothing."""
    js, ts, u0, _ = _cond_pair("eight_schools")
    rng = np.random.default_rng(7)
    q = (u0 + 0.2 * rng.standard_normal(u0.size)).astype(np.float32)
    p = rng.standard_normal(u0.size).astype(np.float32)
    _, g = potential_value_and_grad(ts, torch.tensor(q))
    want = jax.jit(lambda q, p, g: jfl_ref.leapfrog_cond_ref(
        js, q, p, g, 0.1, 8))(*map(jnp.asarray, (q, p, g.numpy())))
    before = dict(LAUNCHES)
    got = fused_leapfrog(ts, torch.tensor(q), torch.tensor(p), g, 0.1, 8)
    batch = fused_leapfrog(ts, torch.tensor(q)[None], torch.tensor(p)[None],
                           g[None], torch.tensor([0.1]), 8)
    assert LAUNCHES == before
    assert _max_abs(got[0], want[0]) < TOL
    assert _max_abs(got[1], want[1]) < TOL
    assert _rel(got[2], want[2]) < TOL
    assert _max_abs(got[3], want[3]) < 1e-4
    for a, b in zip(batch, got):
        assert _max_abs(a[0], b) < 1e-6


@pytest.mark.parametrize("name", sorted(COND_MODELS))
def test_cond_hmc_transition_matches_the_reference(name, monkeypatch):
    """One Metropolis-corrected transition, 4 steps, with the same NumPy
    momentum and accept uniform stubbed into each package's draws: the
    port's batch of one chain (its ``run_chains`` layout, under
    ``vmap``) against ``repro``'s ``hmc_transition`` on its
    ``fused_leapfrog``; q, logp and grad at 1e-5, 1e-5 and 1e-4, the
    accept decision exact."""
    js, ts, u0, pm = _cond_pair(name)
    rng = np.random.default_rng(3)
    q = (u0 + 0.05 * rng.standard_normal(u0.size)).astype(np.float32)
    p0 = rng.standard_normal(u0.size).astype(np.float32)
    uni = np.float32(rng.uniform())
    eps = pm.step_size

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(p0).reshape(shape))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(uni).reshape(shape))
    jlogp, jgrad = jfl.potential_value_and_grad(js, jnp.asarray(q))
    want = jax.jit(lambda q, lp, g: jhmc.hmc_transition(
        None, q, lp, g, eps, jax.random.PRNGKey(0), 4,
        leapfrog_fn=lambda q, p, g, e, n: jfl.fused_leapfrog(
            js, q, p, g, e, n)))(jnp.asarray(q), jlogp, jgrad)

    monkeypatch.setattr(torch, "randn",
                        lambda shape, **kw: torch.tensor(p0).reshape(shape))
    monkeypatch.setattr(torch, "rand",
                        lambda shape, **kw: torch.full(shape, float(uni)))
    qt = torch.tensor(q)[None]
    logp, grad = potential_value_and_grad(ts, qt)
    got = hmc_transition(
        lambda u: potential_value_and_grad(ts, u), qt, logp, grad,
        torch.tensor([eps]), torch.Generator(), 4,
        leapfrog_fn=lambda q, p, g, e, n: fused_leapfrog(ts, q, p, g, e, n))
    assert bool(got[4][0]) == bool(want[4])
    assert _max_abs(got[0][0], want[0]) < TOL
    assert _rel(got[1][0], want[1]) < TOL
    assert _max_abs(got[2][0], want[2]) < 1e-4
    assert abs(float(got[3][0]) - float(want[3])) < 1e-4
