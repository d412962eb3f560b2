"""PyTorch port: the program cache (``repro_torch.core.program``), on
``tests/test_programs.py``'s cases, port against port.

Covers the cache's hit, miss and eviction counters, ``CompiledProgram``'s
calls and signature count (its ``retraces``), the fingerprints, and the
sampler-side contract: a second ``run_chains`` call on the same model and
layout, with another seed, adds no cache miss, no new signature and no
run of the separable-spec compiler (whose probes are five density
evaluations). Then the compile step: ``jit=``, ``static_argnums=``, the
refusal of a non-static Python number, inlining under ``torch.func``,
``disable_capture()``, the per-array switch in the signature, and
``drive_chains`` against the same transitions written out. No JAX: the
contract is the port's own.

On the CPU the port runs eagerly; ``_capture_emulation`` stands in for
CUDA graph capture (the recorded aten ops replayed on the recorded
tensors), so that the capture path's bookkeeping runs here too. The
card's own check is in ``tests/test_torch_kernels_cuda.py`` (``-k
graph``).
"""
import weakref

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import core as tcore
from repro_torch import model, observe, sample
from repro_torch.core import potential as tpotential
from repro_torch.core.program import (CompiledProgram, ProgramCache,
                                      ProgramKey, cache_stats,
                                      data_fingerprint, kernel_fingerprint,
                                      model_fingerprint, model_graph,
                                      program_cache, trace_fingerprint)
from repro_torch.core import program as tprogram
from repro_torch.core.program import CaptureError, disable_capture
from repro_torch.dists import InverseGamma, MvNormalDiag, Normal, Uniform
from repro_torch.infer import HMC, NUTS, run_chains
from repro_torch.infer.chains import drive_chains
from repro_torch.infer.hmc import DualAveraging, hmc_transition, value_and_grad
from repro_torch.kernels import use_fused_logpdf
from repro_torch.kernels.fused_logpdf import ops as logpdf_ops
from repro_torch.models import paper_suite as tsuite
from _capture_emulation import emulate_capture


@model
def linreg(X, y):
    w = sample("w", MvNormalDiag(torch.zeros(3), torch.ones(3)))
    s = sample("s", InverseGamma(2.0, 3.0))
    observe("y", Normal(X @ w, torch.sqrt(s)), y)


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    return torch.tensor(X), torch.tensor(y)


# ---- ProgramCache mechanics (tests/test_programs.py:39-64) ---------------
def test_cache_hit_miss_eviction_counters():
    cache = ProgramCache(maxsize=2)
    k1 = ProgramKey(("m", 1), "t", None, (), "fused", ())
    k2 = ProgramKey(("m", 2), "t", None, (), "fused", ())
    k3 = ProgramKey(("m", 3), "t", None, (), "fused", ())

    p1 = cache.get_or_build(k1, lambda: CompiledProgram(k1, lambda x: x))
    assert cache.get_or_build(k1, lambda: None) is p1  # hit, no rebuild
    cache.get_or_build(k2, lambda: CompiledProgram(k2, lambda x: x))
    cache.get_or_build(k3, lambda: CompiledProgram(k3, lambda x: x))

    s = cache.stats()
    assert s == {**s, "hits": 1, "misses": 3, "evictions": 1, "size": 2}
    assert k1 not in cache  # LRU: k1 was oldest when k3 arrived
    assert k2 in cache and k3 in cache
    cache.clear()
    assert len(cache) == 0 and cache.stats()["misses"] == 0


def test_compiled_program_counts_calls_and_retraces():
    key = ProgramKey(("m",), "t", None, (), "fused", ())
    prog = CompiledProgram(key, lambda x: x * 2)
    prog(torch.ones(3))
    prog(torch.ones(3))
    assert prog.calls == 2 and prog.retraces == 1  # same shape: one trace
    prog(torch.ones(5))
    assert prog.retraces == 2  # new shape forces a retrace
    prog(torch.ones(5, dtype=torch.float64))
    assert prog.retraces == 3  # and so does a new dtype
    prog(x=torch.ones(5))  # a keyword call is another signature
    assert prog.calls == 5 and prog.retraces == 4
    # under vmap the program sees the per-sample (logical) shape
    torch.func.vmap(prog)(torch.ones(7, 3))
    assert prog.retraces == 4


# ---- fingerprints (tests/test_programs.py:221-240) ------------------------
def test_data_fingerprint_separates_content_and_rejects_transformed():
    a = data_fingerprint(np.arange(4.0))
    b = data_fingerprint(np.arange(4.0) + 1)
    assert a != b
    t = data_fingerprint(torch.arange(4.0))
    assert t == data_fingerprint(torch.arange(4.0))
    assert t != data_fingerprint(torch.arange(4.0) + 1)
    assert t != data_fingerprint(torch.arange(4.0, dtype=torch.float64))
    assert data_fingerprint(torch.tensor(2.0)) != \
        data_fingerprint(torch.tensor(3.0))
    assert data_fingerprint(torch.ones(2, dtype=torch.bfloat16)) != \
        data_fingerprint(torch.zeros(2, dtype=torch.bfloat16))

    def fp_inside_transform(x):
        data_fingerprint(x)
        return x

    with pytest.raises(ValueError, match="traced data"):
        torch.func.vmap(fp_inside_transform)(torch.ones(2, 3))
    with pytest.raises(ValueError, match="traced data"):
        torch.func.grad(lambda x: fp_inside_transform(x).sum())(torch.ones(3))


def test_model_fingerprint_distinguishes_bound_data():
    X, y = _data()
    m1, m2 = linreg(X, y), linreg(X, y + 1)
    assert model_fingerprint(m1) != model_fingerprint(m2)
    assert model_fingerprint(m1) == model_fingerprint(linreg(X, y))
    assert model_fingerprint(linreg) == ("modelgen", "linreg", linreg._uid)

    # a second generator of the same name: another uid
    again = model(linreg.fn)
    assert again.name == "linreg" and again._uid != linreg._uid
    assert model_fingerprint(again(X, y)) != model_fingerprint(m1)
    with pytest.raises(TypeError):
        model_fingerprint(object())


def test_trace_and_kernel_fingerprints():
    @model
    def bounded(hi):
        sample("u", Uniform(0.0, hi))

    gen = torch.Generator().manual_seed(0)
    t1 = bounded(2.0).typed_varinfo(gen).link()
    t2 = bounded(3.0).typed_varinfo(gen).link()
    assert t1.layout == t2.layout
    # the package program bakes the stored dists' bounds: keyed apart
    assert trace_fingerprint(t1) != trace_fingerprint(t2)
    assert trace_fingerprint(t1) == trace_fingerprint(
        bounded(2.0).typed_varinfo(gen).link())
    assert kernel_fingerprint(HMC()) == kernel_fingerprint(HMC())
    assert kernel_fingerprint(HMC()) != kernel_fingerprint(HMC(n_leapfrog=8))
    assert kernel_fingerprint(HMC()) != kernel_fingerprint(NUTS())
    assert kernel_fingerprint(lambda q: q) is None
    # the dependency graph is cached once a model, layout and context:
    # the potential compiler (linked trace) and Model.analyze (unlinked)
    # share the build, and another model misses
    m = bounded(2.0)
    misses = program_cache().misses
    g = model_graph(m, t1)
    assert g.node("u").dist == "Uniform" and not g.dynamic
    hits = program_cache().hits
    assert model_graph(m, t1.invlink()) is g
    assert program_cache().hits == hits + 1
    assert program_cache().misses == misses + 1
    assert model_graph(bounded(3.0), t2) is not g


def test_exports_match_the_reference_names():
    for name in ("CompiledProgram", "ProgramCache", "ProgramKey",
                 "program_cache", "cache_stats", "clear_cache"):
        assert name in tcore.__all__ and hasattr(tcore, name)
    assert repro_torch.program_cache is program_cache
    assert repro_torch.cache_stats is cache_stats


# ---- sampler-side reuse (tests/test_programs.py:242-257) -----------------
def test_repeated_run_chains_adds_no_miss_and_no_probe(monkeypatch):
    X, y = _data(16)
    m = linreg(X, y)
    kernel = HMC(step_size=0.05, n_leapfrog=4, adapt_step_size=False)
    compiles = []
    real = tpotential.compile_potential
    monkeypatch.setattr(tpotential, "compile_potential",
                        lambda *a, **k: compiles.append(1) or real(*a, **k))

    def go(seed):
        return run_chains(seed, m, kernel, num_samples=20, num_warmup=10,
                          num_chains=2, device="cpu")

    go(0)  # cold: builds the density, the spec and the package program
    assert len(compiles) == 1
    before = cache_stats()
    ch = go(1)  # same model and layout, another seed: everything cached
    after = cache_stats()
    assert after["misses"] == before["misses"], (before, after)
    assert after["retraces"] == before["retraces"], (before, after)
    assert after["hits"] >= before["hits"] + 3  # density, spec, package
    assert len(compiles) == 1  # no second compile, so no probes
    assert ch.num_chains == 2 and ch.num_samples == 20
    # another backend is another density program
    run_chains(1, m, kernel, num_samples=2, num_chains=2, device="cpu",
               backend="reference")
    assert cache_stats()["misses"] > after["misses"]
    assert len(compiles) == 2


# ---- the compile step (tests/test_programs.py:56-64, and the capture) -----


def _key(kind="t"):
    return ProgramKey(("m",), kind, None, (), "fused", ())


def test_static_argnums_and_jit_false_follow_the_reference_contract():
    prog = CompiledProgram(_key(), lambda x, n: x * n, static_argnums=(1,))
    prog(torch.ones(3), 2)
    prog(torch.ones(3), 2)
    assert prog.calls == 2 and prog.retraces == 1
    prog(torch.ones(3), 3)  # a static argument is keyed by its value
    assert prog.retraces == 2
    with pytest.raises(TypeError, match="not hashable"):
        prog(torch.ones(3), [2])
    eager = CompiledProgram(_key(), lambda x, n: x * n, jit=False)
    assert torch.equal(eager(torch.ones(2), 4.0), torch.full((2,), 4.0))
    eager(torch.ones(2), 5.0)  # no compile step: a number's type only
    assert eager.retraces == 1 and eager.captures == 0


def test_a_python_number_that_is_not_static_is_refused():
    def scale(x, factor):
        return x * factor

    prog = CompiledProgram(_key("scale"), scale)
    with pytest.raises(TypeError, match=r"program 'scale': argument 1 "
                       r"\('factor'\) is a Python float"):
        prog(torch.ones(2), 0.5)
    with pytest.raises(TypeError, match="is a Python int"):
        prog(torch.ones(2), (torch.ones(1), 3))
    assert torch.equal(prog(torch.ones(2), torch.tensor(0.5)),
                       torch.full((2,), 0.5))


def test_a_program_under_torch_func_runs_inline(monkeypatch):
    emulate_capture(monkeypatch)
    prog = CompiledProgram(_key(), lambda q: torch.sum(q * q))
    q = torch.arange(6.0).reshape(3, 2)
    for _ in range(3):  # vmap(grad) of the program: the body inline
        g = torch.func.vmap(torch.func.grad(prog))(q)
    assert torch.equal(g, 2 * q) and prog.captures == 0
    assert prog.retraces == 1  # the per-sample signature
    X, y = _data(8)
    m = linreg(X, y)
    tvi = m.typed_varinfo(torch.Generator().manual_seed(0)).link()
    dens = tprogram.density_program(m, tvi, cache=ProgramCache())
    lp, grad = value_and_grad(dens)(tvi.flat().expand(2, -1).clone())
    assert lp.shape == (2,) and grad.shape == (2, tvi.num_flat)
    assert dens.captures == 0


def test_capture_at_the_second_call_and_disable_capture(monkeypatch):
    emulate_capture(monkeypatch)

    def body(x, gen):
        return x * 2 + torch.randn(x.shape, generator=gen)

    prog = CompiledProgram(_key(), body)
    gen = torch.Generator().manual_seed(0)
    outs = [prog(torch.full((3,), float(i)), gen) for i in range(4)]
    assert (prog.retraces, prog.captures, prog.replays) == (1, 1, 3)
    assert outs[1] is not outs[2]  # fresh outputs, as jax returns
    again = torch.Generator().manual_seed(0)
    with disable_capture():
        want = [body(torch.full((3,), float(i)), again) for i in range(4)]
        prog(torch.ones(3), again)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert prog.captures == 1 and prog.replays == 3  # ran eagerly
    # another generator replays the same graph from its own state
    other = torch.Generator().manual_seed(7)
    got = prog(torch.ones(3), other)
    assert torch.equal(got, body(torch.ones(3),
                                 torch.Generator().manual_seed(7)))
    assert not torch.equal(other.get_state(),  # the caller's advanced
                           torch.Generator().manual_seed(7).get_state())
    assert prog.captures == 1


def test_pinned_donated_and_a_failed_capture(monkeypatch):
    emulate_capture(monkeypatch)
    weights = torch.ones(3)

    def body(w, x, acc):
        acc.add_(w * x)  # acc is donated: written in place
        return acc.sum()

    prog = CompiledProgram(_key(), body, donate_argnums=(2,))
    acc = torch.zeros(3)
    for i in range(3):
        prog(weights, torch.full((3,), float(i)), acc)
    assert torch.equal(acc, torch.full((3,), 3.0)) and prog.captures == 1
    weights.mul_(2)  # a pinned argument is read where it lies
    prog(weights, torch.ones(3), acc)
    assert torch.equal(acc, torch.full((3,), 5.0))
    other = torch.zeros(3)  # another donated tensor: copied in and back
    prog(weights, torch.ones(3), other)
    assert torch.equal(other, torch.full((3,), 2.0))
    assert torch.equal(acc, torch.full((3,), 5.0))  # left as it was
    prog(torch.ones(3), torch.ones(3), acc)  # another pinned one: recapture
    prog(torch.full((3,), 3.0), torch.ones(3), acc)
    assert torch.equal(acc, torch.full((3,), 9.0)) and prog.captures == 2

    synced = CompiledProgram(_key("synced"), lambda x: x * x.sum().item())
    synced(torch.ones(2))
    with pytest.raises(CaptureError, match="program 'synced' could not be "
                       "captured.*not permitted when stream is capturing"):
        synced(torch.ones(2))


def test_replays_add_the_launches_counted_at_capture(monkeypatch):
    emulate_capture(monkeypatch)

    def body(x):  # counts as a kernel wrapper does where it launches
        logpdf_ops.LAUNCHES["std_normal_sum"] += 1
        return x + 1

    logpdf_ops.reset_launch_counts()
    prog = CompiledProgram(_key(), body)
    for _ in range(5):
        prog(torch.ones(2))
    assert prog.captures == 1 and prog.replays == 4
    assert logpdf_ops.LAUNCHES["std_normal_sum"] == 5
    logpdf_ops.reset_launch_counts()


def test_the_switch_state_is_part_of_the_signature():
    tcore.clear_cache()
    prog = CompiledProgram(_key(), lambda x: x + 1)
    prog(torch.ones(2))
    with use_fused_logpdf():
        prog(torch.ones(2))
    prog(torch.ones(2))
    assert prog.retraces == 2
    X, y = _data(16)
    m = linreg(X, y)
    kernel = HMC(step_size=0.05, adapt_step_size=False)
    run_chains(0, m, kernel, 2, num_chains=2, device="cpu")
    with use_fused_logpdf():
        run_chains(0, m, kernel, 2, num_chains=2, device="cpu")
    keys = [k for k in program_cache().keys() if k.kind == "transition"
            and k.model == model_fingerprint(m)]
    assert sorted(k.extra[-1] for k in keys) == [False, True]


@pytest.mark.parametrize("captured", [False, True],
                         ids=["eager", "emulated_capture"])
def test_drive_chains_matches_a_loop_written_out(captured, monkeypatch):
    """``drive_chains`` (warmup ``t`` a device float32 advanced in the
    warm program, draws written at a device index) against the same
    transitions written out from ``hmc_transition``, bit for bit."""
    if captured:
        emulate_capture(monkeypatch)
    pm = tsuite.build("logreg", device="cpu", n=32, dim=3)
    tvi = pm.model.typed_varinfo(torch.Generator().manual_seed(1)).link()
    ld = pm.model.make_logdensity_fn(tvi)
    q0 = tvi.flat() + 0.1 * torch.randn(
        (3, tvi.num_flat), generator=torch.Generator().manual_seed(2))
    kern = HMC(step_size=0.05, adapt_step_size=True).make_kernel(
        ld, tvi.num_flat)
    qs, stats = drive_chains(kern, q0, torch.Generator().manual_seed(0),
                             num_warmup=5, num_samples=6)

    gen = torch.Generator().manual_seed(0)
    ld_grad = value_and_grad(ld)
    da = DualAveraging()
    q = q0
    logp, grad = ld_grad(q)
    da_state = da.init(torch.full((3,), 0.05))
    t = torch.zeros(())
    for _ in range(5):
        q, logp, grad, acc, _, _ = hmc_transition(
            ld_grad, q, logp, grad, torch.exp(da_state[0]), gen, 4)
        da_state = da.update(da_state, acc, t)
        t = t + 1.0
    eps = torch.exp(da_state[1])
    want = []
    for _ in range(6):
        q, logp, grad, acc, _, div = hmc_transition(
            ld_grad, q, logp, grad, eps, gen, 4)
        want.append((q, logp, acc, div))
    assert torch.equal(qs, torch.stack([w[0] for w in want], 1))
    for i, k in enumerate(("logp", "accept_prob", "diverging"), 1):
        assert torch.equal(stats[k], torch.stack([w[i] for w in want], 1))


def test_transition_programs_keep_one_draw_count_and_one_pool(monkeypatch):
    """A cached ``TransitionPrograms`` keeps the draw buffers of its last
    draw count only: a run at another count frees the old buffers and the
    step graph that wrote them, and the next run at the first count
    captures again. Its three programs capture into one ``GraphPool``."""
    emulate_capture(monkeypatch)

    @model
    def reg(X, y):  # a model of its own: one cached TransitionPrograms
        w = sample("w", MvNormalDiag(torch.zeros(3), torch.ones(3)))
        observe("y", Normal(X @ w, 1.0), y)

    X, y = _data(16)
    m = reg(X, y)
    kernel = HMC(step_size=0.05, n_leapfrog=2)

    def go(n):
        return run_chains(0, m, kernel, num_samples=n, num_warmup=3,
                          num_chains=2, device="cpu")

    go(5)
    (progs,) = [v for k, v in program_cache()._entries.items()
                if k.kind == "transition" and k.model[2] == reg._uid]
    (bufs,) = progs._buffers.values()
    first = bufs["draws"]["q"]
    assert first.shape == (2, 5, 3) and progs.step.captures == 1
    graphs = [e for p in progs.programs[:3] for e in p._seen.values()
              if isinstance(e, tprogram._Graph)]
    assert graphs and {id(g.graph.pool) for g in graphs} == {id(progs.pool)}
    old = weakref.ref(first)
    del first, graphs
    a = go(7)
    assert bufs["draws"]["q"].shape == (2, 7, 3)
    assert old() is None  # the 5-draw buffers are gone, graph and all
    assert a["w"].shape == (2, 7, 3)
    b = go(5)
    assert progs.step.captures == 3 and bufs["draws"]["q"].shape[1] == 5
    with disable_capture():
        want = go(5)
    assert np.array_equal(b["w"], want["w"])
