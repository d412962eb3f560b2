"""PyTorch port: probability queries and the query server
(``repro_torch.core.queries``, ``repro_torch.launch.serve``) against
``repro``'s, on ``tests/test_programs.py``'s ``linreg`` and inputs.

The same NumPy data (from seeded generators) go through both packages:
the four query kinds and a 64-draw posterior predictive match
``repro.core.queries.prob`` at 1e-5 relative in float32, compiled and
eager; the grammar's errors carry ``repro``'s messages; four equal-shape
calls build one program; the server's batches, padding and values match
``repro``'s server, and ``serve_queries()``'s counters equal ``repro``'s.
The port's own contracts: a query program is captured (on the CPU through
``tests/_capture_emulation.py``) and equals ``disable_capture()`` bit for
bit; the analysis's query verdict is what ``prepare_query`` builds; the
evaluator's roots are ``np`` and ``torch`` (ROADMAP Queue 3 B8).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
from repro.core import queries as jqueries
from repro.core.program import ProgramCache as JProgramCache
from repro.dists import InverseGamma as JInverseGamma
from repro.dists import MvNormalDiag as JMvNormalDiag
from repro.dists import Normal as JNormal
from repro.launch import serve as jserve
from repro_torch import model, observe, sample
from repro_torch.core import queries as tqueries
from repro_torch.core.program import (GRAPH_COUNTS, ProgramCache,
                                      disable_capture)
from repro_torch.dists import InverseGamma, MvNormalDiag, Normal
from repro_torch.launch import serve as tserve
from _capture_emulation import emulate_capture
from _jax_reference import _reference_compiled_unoptimised  # noqa: F401

DEV = "cpu"
RTOL = 1e-5


@model
def linreg(X, y):
    w = sample("w", MvNormalDiag(torch.zeros(3), torch.ones(3)))
    s = sample("s", InverseGamma(2.0, 3.0))
    observe("y", Normal(X @ w, torch.sqrt(s)), y)


@repro.model
def jlinreg(X, y):
    w = repro.sample("w", JMvNormalDiag(jnp.zeros(3), jnp.ones(3)))
    s = repro.sample("s", JInverseGamma(2.0, 3.0))
    repro.observe("y", JNormal(X @ w, jnp.sqrt(s)), y)


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    return X, y


def _chain(M=64, seed=2):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(M, 3)).astype(np.float32),
            "s": np.exp(rng.normal(size=M)).astype(np.float32)}


def _cases():
    """(spec, bindings for both packages: ``m`` is the model generator or
    the model bound to ``_data()``, as a key into each package)."""
    X, y = _data()
    w0 = np.array([0.5, 0.0, 0.0], np.float32)
    return {
        "likelihood": ("X = Xn, y = yn | w = w0, s = 1.0, model = m",
                       dict(Xn=X, yn=y, w0=w0), "gen"),
        "prior": ("w = w0, s = 1.5 | model = m", dict(w0=w0), "bound"),
        "joint": ("X = Xn, y = yn, w = w0, s = 0.7 | model = m",
                  dict(Xn=X, yn=y, w0=w0), "gen"),
        "prior_data_inputs": ("w = w0, s = 1.0 | X = Xn, y = yn, model = m",
                              dict(Xn=X, yn=y, w0=w0), "gen"),
        "posterior_predictive": ("X = Xn, y = yn | chain = c, model = m",
                                 dict(Xn=X, yn=y, c=_chain()), "gen"),
    }


def _bind(pkg_model, how, b):
    X, y = _data()
    if how == "gen":
        return {**b, "m": pkg_model}
    if pkg_model is linreg:
        return {**b, "m": linreg(torch.tensor(X), torch.tensor(y))}
    return {**b, "m": jlinreg(jnp.asarray(X), jnp.asarray(y))}


@pytest.mark.parametrize("case", list(_cases()))
def test_query_kinds_match_the_reference(case):
    spec, b, how = _cases()[case]
    want = float(jqueries.prob(spec, cache=JProgramCache(),
                               **_bind(jlinreg, how, b)))
    tb = _bind(linreg, how, b)
    got = tqueries.prob(spec, cache=ProgramCache(), device=DEV, **tb)
    eager = tqueries.prob(spec, compiled=False, device=DEV, **tb)
    plain = tqueries._prob_eager(spec, tb, device=DEV, backend="reference")
    assert got.shape == () and got.device.type == "cpu"
    for v in (got, eager, plain):
        np.testing.assert_allclose(float(v), want, rtol=RTOL)


def test_query_program_captured_equals_eager(monkeypatch):
    """Three calls of each kind (eager, capture, replay) with new content
    each time, captured against ``disable_capture()``: bit for bit."""
    emulate_capture(monkeypatch)
    rng = np.random.default_rng(9)
    cache = ProgramCache()
    before = dict(GRAPH_COUNTS)
    for case, (spec, b, how) in _cases().items():
        for _ in range(3):
            b = {k: (rng.normal(size=v.shape).astype(np.float32)
                     if isinstance(v, np.ndarray) else v)
                 for k, v in b.items()}
            if "c" in b:
                b["c"] = {k: np.abs(v) + 0.1 for k, v in _chain(
                    seed=int(rng.integers(100))).items()}
            tb = _bind(linreg, how, b)
            got = tqueries.prob(spec, cache=cache, device=DEV, **tb)
            with disable_capture():
                want = tqueries.prob(spec, cache=cache, device=DEV, **tb)
            assert torch.equal(got, want), case
    # a capture replays its graph at once: 1 + 1 replays a kind
    assert GRAPH_COUNTS["captures"] - before["captures"] == 5
    assert GRAPH_COUNTS["replays"] - before["replays"] == 10


@pytest.mark.parametrize("spec,bindings,needle", [
    ("w = 1.0, model = m", {}, "must contain '|'"),
    (" | model = m", {}, "empty lhs side"),
    ("w = 1.0 | ", None, "empty rhs side"),
    ("w = 1.0, w = 2.0 | model = m", {}, "duplicate name 'w'"),
    ("w | model = m", {}, "no keyword binding"),
    ("w = v | model = m", {}, "unbound name 'v'"),
    ("1bad = 1.0 | model = m", {}, "invalid name"),
], ids=["no-pipe", "empty-lhs", "empty-rhs", "duplicate", "bare-unbound",
        "expr-unbound", "bad-name"])
def test_malformed_specs_raise_the_reference_errors(spec, bindings, needle):
    errs = []
    for pq, m in ((tqueries, linreg), (jqueries, jlinreg)):
        with pytest.raises(ValueError) as ei:
            pq.parse_query(spec, {} if bindings is None else {"m": m})
        errs.append(str(ei.value))
    assert needle in errs[0] and errs[0] == errs[1]


@pytest.mark.parametrize("expr,needle", [
    ("__import__('os').system('true')", "functions are allowed in query"),
    ("open('/etc/passwd')", "functions are allowed in query"),
    ("(lambda: 1)()", "functions are allowed in query"),
    ("[i for i in range(3)]", "disallowed syntax 'ListComp'"),
    ("w.__class__", "attribute access on 'float' is not allowed"),
    ("m.gen", "attribute access on 'ModelGen' is not allowed"),
], ids=["import", "open", "lambda", "comprehension", "dunder", "attr"])
def test_restricted_evaluator_rejects_as_the_reference(expr, needle):
    for pq, m in ((tqueries, linreg), (jqueries, jlinreg)):
        with pytest.raises(ValueError, match=needle.replace("(", r"\(")):
            pq.parse_query(f"w = {expr} | model = m", {"m": m, "w": 1.0})


@pytest.mark.parametrize("expr", [
    "torch.load('x.pt')", "np.save('x', 1)", "torch.hub", "np.ctypeslib",
    "jnp.ones(3)", "torch.nn.functional.relu(torch.ones(3))"],
    ids=["torch.load", "np.save", "torch.hub", "np.ctypeslib", "jnp",
         "torch.nn"])
def test_evaluator_roots_are_np_and_torch(expr):
    """ROADMAP Queue 3 B8: ``np`` and ``torch`` (with their linalg, fft,
    special and np.random submodules) are the roots; their file and
    global-state functions and other submodules are refused, and ``jnp``
    is unbound."""
    lhs, _ = tqueries.parse_query(
        "w = torch.ones(3) * np.float32(2.0) + torch.linalg.norm("
        "torch.ones(4)) | model", {"model": linreg})
    np.testing.assert_allclose(np.asarray(lhs["w"]), [4.0, 4.0, 4.0])
    with pytest.raises(ValueError):
        tqueries.parse_query(f"w = {expr} | model = m", {"m": linreg})


def test_ppd_builds_one_program_for_equal_shapes():
    X, y = _data()
    cache = ProgramCache()
    rng = np.random.default_rng(1)
    spec = "X = Xn, y = yn | chain = c, model = m"
    for _ in range(4):  # fresh content each call, same shapes
        chain = {"w": rng.normal(size=(1000, 3)).astype(np.float32),
                 "s": np.ones(1000, np.float32)}
        tqueries.prob(spec, cache=cache, device=DEV, Xn=X, yn=y, c=chain,
                      m=linreg)
    s = cache.stats()
    assert (s["misses"], s["hits"], s["retraces"]) == (1, 3, 1), s


def test_query_verdict_is_what_prepare_query_builds():
    """Each kind's ``prob`` on a static model leaves a ``query/<kind>``
    program (one a graph may hold) in the cache, and ``analyze()`` says
    "compiled" for each; a model with Python control flow on a drawn value
    gets an eager program (``jit=False``) and the verdict "eager"."""
    X, y = _data(16, seed=4)
    m = linreg(torch.tensor(X), torch.tensor(y))
    cache = ProgramCache()
    specs = {"prior": "w = w0, s = 1.0 | model = m",
             "likelihood": "y = yn | w = w0, s = 1.0, model = m",
             "joint": "y = yn, w = w0, s = 1.0 | model = m",
             "posterior_predictive": "y = yn | chain = c, model = m"}
    for spec in specs.values():
        tqueries.prob(spec, cache=cache, device=DEV, m=m, yn=y,
                      w0=np.zeros(3, np.float32), c=_chain(8))
    progs = {k.kind: cache.get(k) for k in cache.keys()}
    verdict = {q.kind: q.path for q in m.analyze().coverage.queries}
    assert set(progs) == {f"query/{k}" for k in specs}
    assert all(p.jit for p in progs.values())
    assert verdict == dict.fromkeys(specs, "compiled")

    import repro_torch.dists as td

    @model
    def branchy():
        x = sample("x", td.Normal(0.0, 1.0))
        if x > 0:  # Python control flow on a random variable
            observe("y", td.Normal(x, 1.0), 0.2)
        else:
            observe("y", td.Normal(-x, 1.0), 0.2)

    mb = branchy()
    cache = ProgramCache()
    for x in (0.5, -0.5):
        got = tqueries.prob("x = xv | model = m", cache=cache, device=DEV,
                            m=mb, xv=x)
        np.testing.assert_allclose(
            float(got), -0.5 * x * x - 0.5 * np.log(2 * np.pi), rtol=RTOL)
    (key,) = cache.keys()
    assert not cache.get(key).jit
    assert {q.path for q in mb.analyze().coverage.queries} == {"eager"}


def _five_requests(pkg_model):
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(5):
        X = rng.normal(size=(4, 3)).astype(np.float32)
        yv = rng.normal(size=(4,)).astype(np.float32)
        w = rng.normal(size=(3,)).astype(np.float32)
        reqs.append(("X = Xn, y = yn | w = w0, s = 1.0, model = m",
                     {"Xn": X, "yn": yv, "w0": w, "m": pkg_model}))
    return reqs


def test_query_server_batches_and_matches_the_reference(monkeypatch):
    want = jserve.QueryServer(cache=JProgramCache()).serve(
        _five_requests(jlinreg))
    emulate_capture(monkeypatch)
    server = tserve.QueryServer(cache=ProgramCache(), device=DEV)
    for _ in range(3):  # eager, captured, replayed
        out = server.serve(_five_requests(linreg))
        assert len(out) == 5
        np.testing.assert_allclose([float(v) for v in out],
                                   [float(v) for v in want], rtol=RTOL)
    for (spec, b), got in zip(_five_requests(linreg), out):
        one = tqueries.prob(spec, cache=ProgramCache(), device=DEV, **b)
        np.testing.assert_allclose(float(got), float(one), rtol=1e-6)
    st = server.stats
    assert (st.requests, st.groups, st.padded_lanes, st.batches) == \
        (15, 1, 9, 3)
    assert st.latency_s > 0 and st.throughput_qps > 0


def test_serve_queries_stats_equal_the_reference():
    want = jserve.serve_queries().as_dict()
    got = tserve.serve_queries(device=DEV).as_dict()
    keys = ("requests", "batches", "groups", "padded_lanes", "cache_hits",
            "cache_misses")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_serve_cli_prints_the_two_lines(capsys):
    assert tserve.main(["--queries", "--requests", "6", "--device",
                        "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(line.startswith("[serve]") for line in out)
    assert out[0].startswith("[serve] 6 queries in 2 batches")
