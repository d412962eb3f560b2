"""PyTorch port: the static analysis (dependency graph, lints, coverage,
reports, ``python -m repro_torch.analyze``) against the JAX package.

The models of ``tests/test_analysis.py`` are written twice, once in each
package, from the same NumPy arrays; each package's graph is built on its
own discovery trace (the graph is structural: it does not depend on the
drawn values). Held equal: every node's name, kind, distribution,
support, shape, dtype and unconstrained slice, its ``deps`` and
``field_deps``, ``head_syms``, the coupling edge, the dynamic verdict
and the lint findings (pass, severity, site). Then the port's own tracer
(in-place ops, views, host reads, data-dependent shapes), the coverage
table against the fused evaluator's runtime blocks, ``Model.analyze``,
the report (checked by both packages' validators) and the CLI's exit
status; and a conditional ``run_chains`` under the CPU stand-in for
CUDA-graph capture against ``disable_capture()``, bit for bit.
"""
import json
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.dists as jd
import repro_torch
import repro_torch.dists as td
from repro.analysis import build_model_graph as jbuild_graph
from repro.analysis import run_lints as jrun_lints
from repro.analysis import validate_analysis_report as jvalidate
from repro.core.varinfo import typify as jtypify
from repro.models import paper_suite as jsuite
from repro_torch.analysis import (analyze_model, build_analysis_report,
                                  build_model_graph, fusion_coverage,
                                  run_lints, validate_analysis_report,
                                  write_analysis_report)
from repro_torch.analysis.tracer import ConcretizationError, DependencyTracer
from repro_torch.core.program import disable_capture
from repro_torch.core.varinfo import typify
from repro_torch.infer import HMC, run_chains
from repro_torch.models import paper_suite as tsuite
from _capture_emulation import emulate_capture
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401


# ---------------------------------------------------------------------------
# the models of tests/test_analysis.py, in both packages
# ---------------------------------------------------------------------------
def _pair(body):
    """``body(pkg, dists, np_to)`` written once, bound in both packages."""
    @repro.model
    def jm():
        body(repro, jd, jnp.asarray)

    @repro_torch.model
    def tm():
        body(repro_torch, td, torch.tensor)

    return jm(), tm()


def _sep(pkg, d, arr):
    pkg.sample("a", d.Normal(arr(np.zeros(4, np.float32)), 1.0))
    pkg.sample("g", d.Gamma(2.0, 1.0))


def _dup(pkg, d, arr):
    a = pkg.sample("x", d.Normal(0.0, 1.0))
    b = pkg.sample("x", d.Normal(0.0, 1.0))
    pkg.observe("y", d.Normal(a + b, 1.0), 0.3)


def _disc(pkg, d, arr):
    z = pkg.sample("z", d.Categorical(logits=arr(np.zeros(3, np.float32))))
    pkg.observe("y", d.Normal(arr(np.array([0.0, 1.0, 2.0],
                                           np.float32))[z], 1.0), 0.5)


def _bad_obs(pkg, d, arr):
    pkg.sample("p", d.Beta(2.0, 2.0))
    pkg.observe("y", d.Beta(2.0, 2.0), 1.7)  # Beta support is (0, 1)


def _branchy(pkg, d, arr):
    x = pkg.sample("x", d.Normal(0.0, 1.0))
    if x > 0:  # Python control flow on a random variable
        pkg.observe("y", d.Normal(x, 1.0), 0.2)
    else:
        pkg.observe("y", d.Normal(-x, 1.0), 0.2)


def _orphan(pkg, d, arr):
    a = pkg.sample("a", d.Normal(0.0, 1.0))
    pkg.sample("b", d.Normal(0.0, 1.0))  # never reaches the data
    pkg.observe("y", d.Normal(a, 1.0), 0.1)


def _suite(name, **kw):
    return (jsuite.build(name, **kw).model,
            tsuite.build(name, device="cpu", **kw).model)


PAIRS = {
    "eight_schools": lambda: _suite("eight_schools"),
    "gauss_unknown": lambda: _suite("gauss_unknown", n=200),
    "hier_poisson": lambda: _suite("hier_poisson"),
    "sep": lambda: _pair(_sep), "dup": lambda: _pair(_dup),
    "disc": lambda: _pair(_disc), "bad_obs": lambda: _pair(_bad_obs),
    "branchy": lambda: _pair(_branchy), "orphan": lambda: _pair(_orphan),
}
# the lint each purpose-built model must trigger, and on which site
LINTS = {"dup": ("duplicate-site", "error", "x"),
         "disc": ("discrete-param", "error", "z"),
         "bad_obs": ("observed-support", "error", "y"),
         "branchy": ("dynamic-structure", "error", None),
         "orphan": ("unused-site", "warning", "b")}


def _graphs(name):
    jm, tm = PAIRS[name]()
    jg = jbuild_graph(jm, jtypify(jm.untyped_trace(jax.random.PRNGKey(0))))
    tg = build_model_graph(tm, typify(tm.untyped_trace(
        torch.Generator().manual_seed(0))))
    return jg, tg, tm


def _node_fields(n):
    return (n.name, n.kind, n.dist, n.support, tuple(n.shape), n.dtype,
            n.unc_offset, n.unc_size, n.deps, n.field_deps)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_graph_and_lints_equal_the_reference(name):
    jg, tg, _ = _graphs(name)
    assert [_node_fields(n) for n in tg.nodes] == \
        [_node_fields(n) for n in jg.nodes]
    assert tg.head_syms() == jg.head_syms()
    assert tg.coupling_edge() == jg.coupling_edge()
    assert tg.edges() == jg.edges()
    assert tg.duplicates == jg.duplicates
    assert tg.dynamic == jg.dynamic
    if tg.dynamic:
        assert tg.dynamic_reason.startswith(
            "model structure depends on a traced random variable")
    tf = [(f.pass_id, f.severity, f.site) for f in run_lints(tg)]
    assert tf == [(f.pass_id, f.severity, f.site) for f in jrun_lints(jg)]
    if name in LINTS:
        assert LINTS[name] in tf
    else:  # the paper models stay lint-clean
        assert [f for f in tf if f[1] == "error"] == []


def test_eight_schools_graph_slices_and_roles():
    """``tests/test_analysis.py``'s structure checks, on the port alone:
    theta's slice of the flat buffer and the head/leaf split."""
    _, g, tm = _graphs("eight_schools")
    tvi = typify(tm.untyped_trace(torch.Generator().manual_seed(0)))
    assert [n.name for n in g.nodes] == ["mu", "tau", "theta", "y"]
    assert g.node("theta").field_dep("loc") == ("mu",)
    assert g.node("theta").field_dep("scale") == ("tau",)
    assert g.node("y").field_dep("loc") == ("theta",)
    th = g.node("theta")
    sl = slice(th.unc_offset, th.unc_offset + th.unc_size)
    assert torch.equal(tvi.flat()[sl], tvi["theta"].reshape(-1))
    assert g.reaches_data("mu") and not g.dynamic
    assert [n.name for n in g.dependents("theta")] == ["y"]


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------
def test_tracer_propagates_through_ops_inplace_writes_and_views():
    tr = DependencyTracer()
    a = tr.tag(torch.ones(3), "a")
    b = tr.tag(torch.ones(3), "b")
    data = torch.arange(3.0)
    with tr:
        c = a * 2.0 + data
        out = torch.zeros(3)
        out[1] = b[0]                    # __setitem__ writes b into out
        view = out[1:]
        buf = torch.zeros(4)
        buf[:2].add_(a[:2])              # a write through a view
        z = torch.zeros_like(a)          # value-free
        stacked = torch.stack([c, data])
        data.tolist(), bool(data[0] == 0), int(data[1])  # data reads free
    assert tr.deps(c) == {"a"} and tr.deps(out) == {"b"}
    assert tr.deps(view) == {"b"} and tr.deps(buf) == {"a"}
    assert tr.deps(z) == frozenset() and tr.deps(stacked) == {"a"}
    assert tr.deps(data) == frozenset()


@pytest.mark.parametrize("read", [
    bool, int, float, operator.index, complex,
    lambda t: t.item(), lambda t: t.tolist(), lambda t: t.numpy(),
    np.asarray, torch.nonzero, lambda t: t[t > 0],
    lambda t: torch.masked_select(t, t > 0), torch.unique,
    lambda t: torch.where(t > 0)],
    ids=["bool", "int", "float", "index", "complex", "item", "tolist",
         "numpy", "array", "nonzero", "mask_index", "masked_select",
         "unique", "where1"])
def test_tracer_refuses_host_reads_of_traced_values(read):
    tr = DependencyTracer()
    x = tr.tag(torch.ones((), dtype=torch.int64), "x")
    with tr, pytest.raises(ConcretizationError, match=r"\['x'\]"):
        read(x + 1)


# ---------------------------------------------------------------------------
# coverage, Model.analyze, the report and the CLI
# ---------------------------------------------------------------------------
def test_coverage_matches_fused_evaluator_blocks():
    from repro_torch.core.interpreters import FusedEvaluator

    @repro_torch.model
    def mix(y):
        repro_torch.sample("n", td.Normal(torch.zeros(8), 2.0))
        repro_torch.sample("g", td.Gamma(2.0 * torch.ones(5), 1.5))
        repro_torch.sample("u", td.Uniform(-1.0, 2.0))  # no family
        repro_torch.observe("y", td.Normal(torch.zeros(4), 1.0), y)

    m = mix(0.1 * torch.ones(4))
    tvi = typify(m.untyped_trace(torch.Generator().manual_seed(0)))
    cov = fusion_coverage(m, build_model_graph(m, tvi), tvi)
    ev = FusedEvaluator(tvi, None)
    m._run(ev)
    runtime = sorted(fam for (fam, _, _), segs in ev._site_blocks.items()
                     for _ in segs)
    reported = sorted(s.fused_family for s in cov.sites
                      if s.fused_family is not None)
    assert reported == runtime
    assert cov.site("u").fused_family is None
    assert "Uniform" in cov.site("u").fused_reason
    assert cov.potential_kind == "separable"
    assert cov.site("u").leapfrog_op == "SOFTPLUS"


def test_model_analyze_roundtrip_and_both_validators():
    a = tsuite.build("eight_schools", device="cpu").model.analyze()
    assert a.ok and a.findings == []
    cov = a.coverage
    assert cov.potential_kind == "conditional"
    assert [cov.site(s).leapfrog_role for s in ("mu", "tau", "theta")] == \
        ["head", "head", "leaf"]
    assert cov.site("theta").leapfrog_op == "NORMAL"
    text = a.render()
    assert "conditional (coupled head: mu, tau)" in text and "theta" in text
    report = build_analysis_report([a])
    assert validate_analysis_report(report) == []
    assert jvalidate(json.loads(json.dumps(report))) == []
    assert report["machine"]["torch"] == torch.__version__
    bad = dict(report, models=[dict(report["models"][0], n_errors=1)])
    assert validate_analysis_report(bad) == jvalidate(bad) != []
    with pytest.raises(ValueError, match="invalid analysis report"):
        write_analysis_report("unused.json", bad)


def test_analyze_model_reports_errors():
    _, tm = _pair(_disc)
    a = analyze_model(tm)
    assert not a.ok
    assert any(f.pass_id == "discrete-param" for f in a.errors())
    assert a.coverage.potential_kind is None
    assert "discrete" in a.coverage.potential_reason


def test_cli_exit_status_and_json(tmp_path, capsys):
    from repro_torch.analyze import main

    out = tmp_path / "report.json"
    assert main(["--models", "eight_schools", "--json", str(out),
                 "--device", "cpu", "--quiet"]) == 0
    report = json.loads(out.read_text())
    assert validate_analysis_report(report) == [] == jvalidate(report)
    assert [m["name"] for m in report["models"]] == ["eight_schools"]
    assert report["models"][0]["potential"]["kind"] == "conditional"
    src = tmp_path / "models.py"
    src.write_text(
        "import torch\n"
        "from repro_torch import model, observe, sample\n"
        "from repro_torch.dists import Categorical, Normal\n\n"
        "@model\n"
        "def disc(y=0.5):\n"
        "    z = sample('z', Categorical(logits=torch.zeros(3)))\n"
        "    observe('y', Normal(torch.tensor([0.0, 1.0, 2.0])[z], 1.0), y)\n"
        "\n\n@model\n"
        "def needs_data(y):\n"
        "    observe('y', Normal(0.0, 1.0), y)\n")
    assert main(["--files", str(src), "--quiet"]) == 1
    text = capsys.readouterr()
    assert "disc: 1 error(s)" in text.out
    assert "needs_data: skipped" in text.err


# ---------------------------------------------------------------------------
# the conditional route captured
# ---------------------------------------------------------------------------
def test_conditional_run_chains_captured_matches_eager(monkeypatch):
    """eight_schools on the conditional integrator (``leapfrog="auto"``)
    through ``run_chains``: its transitions recorded and replayed by the
    CPU stand-in for CUDA-graph capture, equal to the same run under
    ``disable_capture()`` bit for bit. The replayed ``aux_fn`` reads
    nothing on the host (the stand-in raises on a host read)."""
    emulate_capture(monkeypatch)
    m = tsuite.build("eight_schools", device="cpu").model
    kernel = HMC(step_size=0.1, n_leapfrog=4, adapt_step_size=True)

    def go():
        return run_chains(3, m, kernel, 6, num_warmup=4, num_chains=3,
                          device="cpu")

    got = go()
    from repro_torch.core.program import program_cache
    progs = [v for k, v in program_cache()._entries.items()
             if k.kind == "transition" and k.model[1] == m.gen.name]
    assert progs and progs[-1].step.captures == 1
    assert progs[-1].warm.captures == 1
    with disable_capture():
        want = go()
    for k in ("mu", "tau", "theta"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("logp", "accept_prob"):
        assert np.array_equal(got.stats[k], want.stats[k]), k
