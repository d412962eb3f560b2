"""PyTorch port: the program cache (``repro_torch.core.program``), on
``tests/test_programs.py``'s cases, port against port.

Covers the cache's hit, miss and eviction counters, ``CompiledProgram``'s
calls and signature count (its ``retraces``), the fingerprints, and the
sampler-side contract: a second ``run_chains`` call on the same model and
layout, with another seed, adds no cache miss, no new signature and no
run of the separable-spec compiler (whose probes are five density
evaluations). No JAX: the contract is the port's own.
"""
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
from repro_torch.dists import InverseGamma, MvNormalDiag, Normal, Uniform
from repro_torch.infer import HMC, NUTS, run_chains


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
    with pytest.raises(NotImplementedError, match="item 5"):
        model_graph(None, t1)


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
