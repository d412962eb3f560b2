"""Lint passes over the :class:`~repro_torch.analysis.graph.ModelGraph`.

Each pass is a pure function ``(graph) -> [LintFinding]``; ``run_lints``
runs them all in a fixed order. Error-severity findings are conditions
under which gradient-based inference is wrong or impossible (duplicate
sites, discrete parameters, data outside the likelihood's support,
RV-dependent Python control flow); warnings are smells (unused sites,
float64 promotion leaks) that run but waste work or precision.

The passes deliberately consume only what the graph already recorded —
one analysis run, many consumers — so linting a model costs nothing
beyond ``build_model_graph``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.graph import ModelGraph
from repro_torch.core.varinfo import _DISCRETE_SUPPORTS

__all__ = ["LintFinding", "run_lints", "LINT_PASSES"]


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One lint result: which pass fired, how bad, where, and why."""

    pass_id: str
    severity: str            # "error" | "warning"
    site: Optional[str]      # offending site name (None = whole model)
    message: str

    def __str__(self):
        where = f" [{self.site}]" if self.site else ""
        return f"{self.severity}: {self.pass_id}{where}: {self.message}"


def _lint_duplicate_sites(graph: ModelGraph) -> List[LintFinding]:
    """A varname used twice (or both whole and element-indexed) silently
    double-counts its density — always a model bug."""
    out = []
    for name in graph.duplicates:
        out.append(LintFinding(
            "duplicate-site", "error", name,
            f"site '{name}' is recorded more than once per model "
            "execution (same name reused, or a symbol sampled both whole "
            "and element-indexed); its density would be double-counted"))
    return out


def _lint_discrete_params(graph: ModelGraph) -> List[LintFinding]:
    out = []
    for n in graph.param_nodes():
        if n.support in _DISCRETE_SUPPORTS:
            out.append(LintFinding(
                "discrete-param", "error", n.name,
                f"parameter site '{n.name}' has discrete support "
                f"({n.support}); HMC/NUTS/ADVI cannot move it — "
                "marginalise it out inside the model or sample it with a "
                "non-gradient kernel"))
    return out


def _lint_observed_support(graph: ModelGraph) -> List[LintFinding]:
    """Observed data outside the likelihood's support makes the density
    -inf (or silently nan) at EVERY point — inference cannot recover."""
    out = []
    for r in graph.records:
        if r.kind != "observed" or r.dist is None:
            continue
        chk = getattr(r.dist, "in_support", None)
        if chk is None:
            continue
        try:
            ok = torch.as_tensor(chk(torch.as_tensor(r.value)))
            ok = ok.detach().cpu().numpy()
        except Exception:
            continue  # a value the check cannot take: nothing to check
        if not bool(np.all(ok)):
            bad = int(ok.size - np.count_nonzero(ok)) if ok.shape else 1
            out.append(LintFinding(
                "observed-support", "error", r.name,
                f"observed value(s) at site '{r.name}' lie outside the "
                f"support of {type(r.dist).__name__} "
                f"({bad} offending element(s)); the log-likelihood is "
                "-inf/nan everywhere"))
    return out


def _lint_dynamic_structure(graph: ModelGraph) -> List[LintFinding]:
    """Python control flow on a random variable retraces (or breaks) the
    compiled density — the paper's static-trace contract is violated."""
    if not graph.dynamic:
        return []
    return [LintFinding(
        "dynamic-structure", "error", None,
        f"{graph.dynamic_reason}; the compiled density/specialised "
        "kernels assume a fixed site structure — rewrite the branch with "
        "torch.where on values, not on model structure")]


def _lint_dtype_promotion(graph: ModelGraph) -> List[LintFinding]:
    """float64 leaking into the trace doubles memory traffic and silently
    falls off the fused float32 kernel paths."""
    out = []
    seen = set()
    for r in graph.records:
        if r.kind in ("factor", "reject") or r.name in seen:
            continue
        seen.add(r.name)
        try:
            dt = torch.as_tensor(r.value).dtype
        except Exception:
            continue
        if dt == torch.float64:
            out.append(LintFinding(
                "dtype-promotion", "warning", r.name,
                f"site '{r.name}' carries float64 values; the fused "
                "kernels and flat buffers are float32 — cast the data "
                "to float32 to stay on the hot path"))
    return out


def _lint_unused_sites(graph: ModelGraph) -> List[LintFinding]:
    """A parameter with no dataflow path to any observation/factor is
    pure prior — often a typo'd name. Only meaningful when the model has
    data at all (pure-prior benchmark models are legitimate)."""
    if graph.dynamic:
        return []  # dataflow edges are unreliable under dynamic structure
    if not any(n.kind in ("observed", "factor") for n in graph.nodes):
        return []
    out = []
    for n in graph.param_nodes():
        if not graph.reaches_data(n.name):
            out.append(LintFinding(
                "unused-site", "warning", n.name,
                f"parameter site '{n.name}' has no dataflow path to any "
                "observation or factor term; it is sampled from its "
                "prior only — possibly a misspelled or orphaned site"))
    return out


LINT_PASSES = (
    _lint_duplicate_sites,
    _lint_discrete_params,
    _lint_observed_support,
    _lint_dynamic_structure,
    _lint_dtype_promotion,
    _lint_unused_sites,
)


def run_lints(graph: ModelGraph) -> List[LintFinding]:
    """Run every lint pass; errors first, program order within severity."""
    findings: List[LintFinding] = []
    for p in LINT_PASSES:
        findings.extend(p(graph))
    findings.sort(key=lambda f: 0 if f.severity == "error" else 1)
    return findings
