"""PyTorch port: the fused leapfrog and fused potential against the JAX
package, and the fused integrator against the autodiff one.

Specs are compiled by ``repro`` (every opcode, alone and mixed) and carried
across with ``spec_from_reference``; states are made with NumPy from a
seed. The port's wrappers run their plain versions on the CPU; the JAX
side runs its Pallas kernels in interpret mode, once per chain with that
chain's step size. Tolerances are those of ``tests/test_fused_leapfrog.py``:
max abs 1e-5 on q and p, 1e-4 on the gradient, and 1e-5 on
``|logp - ref| / (1 + |ref|)``. The CUDA kernels themselves run only on a
GPU: ``test_torch_kernels_cuda.py`` holds them.
"""
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
from repro_torch.convert import spec_from_reference
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

TOL = 1e-5
EPS = np.array([0.05, 0.03, 0.08], np.float32)  # one step size per chain


def _sites(kind):
    if kind in ("mix", "normal"):
        repro.sample("n", Normal(jnp.zeros(8), 2.0))
        repro.sample("l", LogNormal(0.5, 1.2))
    if kind in ("mix", "exp"):
        repro.sample("g", Gamma(2.0 * jnp.ones(5), 1.5))
        repro.sample("h", HalfNormal(0.5))
        repro.sample("e", Exponential(0.7 * jnp.ones(2)))
    if kind in ("mix", "softplus"):
        repro.sample("b", Beta(2.0, 3.0))
        repro.sample("u", Uniform(-1.0, 2.0))
    if kind in ("mix", "tlog"):
        repro.sample("t", StudentT(4.0, 0.0, jnp.ones(3)))
        repro.sample("c", Cauchy(0.0, 2.0))
    if kind in ("mix", "zero"):
        repro.sample("f", Flat(jnp.zeros(4)))


KINDS = {"mix": None, "zero": OP_ZERO, "normal": OP_NORMAL, "exp": OP_EXP,
         "softplus": OP_SOFTPLUS, "tlog": OP_TLOG}


@pytest.fixture(scope="module", params=list(KINDS))
def spec_pair(request):
    """A spec compiled by ``repro`` and the port's copy of it."""
    kind = request.param

    @repro.model
    def family_mix():
        _sites(kind)

    m = family_mix()
    tvi = m.typed_varinfo(jax.random.PRNGKey(0)).link()
    js = jbuild_spec(m, tvi, backend="fused")
    assert js.uniform_op == KINDS[kind]
    ts = spec_from_reference(js.op, js.c0, js.c1, js.c2, js.c3, js.const,
                             js.dim)
    assert ts.uniform_op == js.uniform_op
    return js, ts, np.asarray(tvi.flat(), np.float32)


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


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("metric", ["unit", "diag"])
def test_fused_leapfrog_matches_jax_pallas_kernel(spec_pair, metric):
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
    for c, eps in enumerate(EPS):
        want = jfl.fused_leapfrog(
            js, jnp.asarray(q[c]), jnp.asarray(p[c]), jnp.asarray(g[c]),
            float(eps), 8, inv_mass=None if im is None else jnp.asarray(im),
            use_pallas=True, interpret=True)
        wq, wp, wlp, wg = want
        assert _max_abs(got[0][c], wq) < TOL
        assert _max_abs(got[1][c], wp) < TOL
        assert _rel(got[2][c], wlp) < TOL
        assert _max_abs(got[3][c], wg) < 1e-4


@pytest.mark.pallas_interpret
def test_potential_value_and_grad_matches_jax_pallas_kernel(spec_pair):
    js, ts, u0 = spec_pair
    q, _, _ = _states(u0, seed=11)
    logp, g = potential_value_and_grad(ts, torch.tensor(q))
    assert logp.shape == (len(EPS),) and g.shape == q.shape
    for c in range(len(EPS)):
        wlp, wg = jfl.potential_value_and_grad(js, jnp.asarray(q[c]),
                                               use_pallas=True,
                                               interpret=True)
        assert _rel(logp[c], wlp) < TOL
        assert _max_abs(g[c], wg) < TOL
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
    wlp, wg = jfl.potential_value_and_grad(js, jnp.asarray(q[0]),
                                           use_pallas=False)
    assert _rel(lp, wlp) < TOL and _max_abs(gg, wg) < TOL
    want = jfl.fused_leapfrog(js, jnp.asarray(q[0]), jnp.asarray(p[0]),
                              jnp.asarray(g[0].numpy()), float(EPS[0]), 4,
                              use_pallas=False)
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
