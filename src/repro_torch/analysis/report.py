"""Analysis reports: one container tying graph + lints + coverage together.

``analyze_model`` is the one-stop entry (also exposed as
``Model.analyze()``): it builds the dependency graph once, runs every
lint pass over it, and classifies each site's fusion coverage. The
result renders as a human table (``render``) or serialises to the same
JSON-report shape the benchmark suite uses (``schema_version`` +
``machine`` stamp + per-model entries), so CI can archive and diff
analysis output exactly like ``BENCH_*.json``.

``validate_analysis_report`` checks that shape and returns a list of
problems (empty = valid); it needs nothing beyond the stdlib, so schema
tests can run it against a committed report without importing torch.
"""
from __future__ import annotations

import dataclasses
import json
import platform
from typing import List

__all__ = ["ModelAnalysis", "analyze_model", "build_analysis_report",
           "machine_info", "validate_analysis_report",
           "write_analysis_report", "ANALYSIS_SCHEMA_VERSION"]

ANALYSIS_SCHEMA_VERSION = 1

_FINDING_KEYS = {"pass": str, "severity": str, "message": str}
_SITE_KEYS = {"name": str, "kind": str}


def machine_info() -> dict:
    """Host stamp in the same shape the benchmark reports use."""
    info = {
        "platform": platform.platform(),
        "processor": platform.processor() or platform.machine(),
        "cpu_count": __import__("os").cpu_count(),
        "python": platform.python_version(),
    }
    try:
        import torch
        info["torch"] = torch.__version__
        info["device"] = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu")
    except Exception:
        info["torch"] = None
        info["device"] = None
    return info


@dataclasses.dataclass
class ModelAnalysis:
    """Everything the static analyser knows about one model."""

    model: object                 # the analysed Model (kept for reuse)
    graph: object                 # ModelGraph
    findings: list                # [LintFinding]
    coverage: object              # CoverageReport

    @property
    def name(self) -> str:
        return self.coverage.model

    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        """True when no error-severity finding fired."""
        return not self.errors()

    # -- serialisation -------------------------------------------------
    def to_dict(self) -> dict:
        sites = []
        for s in self.coverage.sites:
            sites.append({
                "name": s.name, "kind": s.kind, "dist": s.dist,
                "fused_family": s.fused_family,
                "fused_reason": s.fused_reason,
                "leapfrog_op": s.leapfrog_op,
                "leapfrog_role": s.leapfrog_role,
                "leapfrog_reason": s.leapfrog_reason,
            })
        return {
            "name": self.name,
            "dynamic": bool(self.graph.dynamic),
            "findings": [{"pass": f.pass_id, "severity": f.severity,
                          "site": f.site, "message": f.message}
                         for f in self.findings],
            "potential": {"kind": self.coverage.potential_kind,
                          "reason": self.coverage.potential_reason,
                          "site": self.coverage.potential_site},
            "sites": sites,
            "queries": [{"kind": q.kind, "path": q.path, "reason": q.reason}
                        for q in getattr(self.coverage, "queries", ())],
            "n_errors": len(self.errors()),
            "n_warnings": len(self.warnings()),
        }

    # -- human rendering ----------------------------------------------
    def render(self) -> str:
        cov = self.coverage
        lines = [f"model {self.name}"]
        kind = cov.potential_kind or "none"
        verdict = f"  potential spec: {kind}"
        if kind == "conditional":
            head = ", ".join(getattr(self.graph, "head_syms", lambda: ())())
            verdict += f" (coupled head: {head or '<empty>'})"
        if cov.potential_reason and kind == "none":
            verdict += f" — {cov.potential_reason}"
        lines.append(verdict)
        if self.findings:
            lines.append(f"  findings ({len(self.errors())} error(s), "
                         f"{len(self.warnings())} warning(s)):")
            for f in self.findings:
                lines.append(f"    {f}")
        else:
            lines.append("  findings: none")
        if cov.queries:
            qbits = []
            for q in cov.queries:
                cell = f"{q.kind}={q.path}"
                if q.path == "eager" and q.reason:
                    cell += f" ({q.reason})"
                qbits.append(cell)
            lines.append("  queries: " + ", ".join(qbits))
        rows = [("site", "kind", "dist", "fused_logpdf", "fused_leapfrog")]
        for s in cov.sites:
            fam = s.fused_family or f"— ({s.fused_reason})"
            if s.leapfrog_role == "separable":
                lf = f"{s.leapfrog_op} (separable)"
            elif s.leapfrog_role == "leaf":
                lf = f"{s.leapfrog_op} (leaf)"
            elif s.leapfrog_role == "head":
                lf = "head (generic replay)"
            else:
                lf = f"— ({s.leapfrog_reason})"
            rows.append((s.name, s.kind, s.dist or "—", fam, lf))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        for j, r in enumerate(rows):
            lines.append("  " + "  ".join(c.ljust(w)
                                          for c, w in zip(r, widths)).rstrip())
            if j == 0:
                lines.append("  " + "  ".join("-" * w for w in widths))
        return "\n".join(lines)


def analyze_model(model, generator=None, tvi=None) -> ModelAnalysis:
    """Build graph, run lints, classify fusion coverage for ``model``.

    ``generator`` (a ``torch.Generator`` or an integer seed, default 0,
    on the device of the model's tensor data) draws the discovery trace
    when ``tvi`` is not given, where ``repro`` takes a key."""
    from repro_torch.analysis.coverage import fusion_coverage
    from repro_torch.analysis.graph import _generator, build_model_graph
    from repro_torch.analysis.lints import run_lints
    from repro_torch.core.varinfo import typify

    if tvi is None:
        try:
            tvi = typify(model.untyped_trace(_generator(model, generator)))
        except Exception:
            tvi = None  # build_model_graph re-traces and reports why
    if tvi is not None and tvi.linked:
        tvi = tvi.invlink()
    # Route through the program cache: if sampling (or a previous analyze)
    # already built the graph for this model+layout, replay it instead of
    # forcing a fresh abstract trace.
    if tvi is not None:
        from repro_torch.core.program import model_graph
        graph = model_graph(model, tvi)
    else:
        graph = build_model_graph(model, tvi, generator=generator)
    findings = run_lints(graph)
    coverage = fusion_coverage(model, graph, tvi)
    return ModelAnalysis(model=model, graph=graph, findings=findings,
                         coverage=coverage)


def build_analysis_report(analyses: List[ModelAnalysis]) -> dict:
    """Bundle per-model analyses into one archivable JSON document."""
    return {
        "schema_version": ANALYSIS_SCHEMA_VERSION,
        "kind": "analysis",
        "machine": machine_info(),
        "models": [a.to_dict() for a in analyses],
    }


def validate_analysis_report(report: dict) -> List[str]:
    """Return a list of schema problems (empty list = valid).

    Stdlib-only on purpose: schema smoke tests run it against committed
    reports without importing torch.
    """
    errs: List[str] = []
    if not isinstance(report, dict):
        return ["report is not a dict"]
    if report.get("schema_version") != ANALYSIS_SCHEMA_VERSION:
        errs.append(f"schema_version != {ANALYSIS_SCHEMA_VERSION}")
    if report.get("kind") != "analysis":
        errs.append("kind != 'analysis'")
    if not isinstance(report.get("machine"), dict):
        errs.append("missing machine stamp")
    models = report.get("models")
    if not isinstance(models, list):
        return errs + ["'models' is not a list"]
    for i, m in enumerate(models):
        tag = f"models[{i}]"
        if not isinstance(m, dict):
            errs.append(f"{tag} is not a dict")
            continue
        if not isinstance(m.get("name"), str):
            errs.append(f"{tag}.name missing/not str")
        for k in ("n_errors", "n_warnings"):
            if not isinstance(m.get(k), int):
                errs.append(f"{tag}.{k} missing/not int")
        pot = m.get("potential")
        if not isinstance(pot, dict) or "kind" not in pot:
            errs.append(f"{tag}.potential missing 'kind'")
        for j, f in enumerate(m.get("findings", []) or []):
            for k, typ in _FINDING_KEYS.items():
                if not isinstance(f.get(k), typ):
                    errs.append(f"{tag}.findings[{j}].{k} missing/not "
                                f"{typ.__name__}")
            if f.get("severity") not in ("error", "warning"):
                errs.append(f"{tag}.findings[{j}].severity invalid")
        sites = m.get("sites")
        if not isinstance(sites, list):
            errs.append(f"{tag}.sites is not a list")
            continue
        for j, s in enumerate(sites):
            for k, typ in _SITE_KEYS.items():
                if not isinstance(s.get(k), typ):
                    errs.append(f"{tag}.sites[{j}].{k} missing/not "
                                f"{typ.__name__}")
        # optional (older reports predate it) but validated when present
        queries = m.get("queries")
        if queries is not None:
            if not isinstance(queries, list):
                errs.append(f"{tag}.queries is not a list")
            else:
                for j, q in enumerate(queries):
                    if not isinstance(q, dict) or not isinstance(
                            q.get("kind"), str):
                        errs.append(f"{tag}.queries[{j}].kind missing")
                        continue
                    if q.get("path") not in ("compiled", "eager"):
                        errs.append(f"{tag}.queries[{j}].path invalid")
        n_err = sum(1 for f in (m.get("findings") or [])
                    if isinstance(f, dict) and f.get("severity") == "error")
        if isinstance(m.get("n_errors"), int) and m["n_errors"] != n_err:
            errs.append(f"{tag}.n_errors={m['n_errors']} but findings "
                        f"contain {n_err} error(s)")
    return errs


def write_analysis_report(path: str, report: dict) -> None:
    """Validate then write; refuses to persist a malformed report."""
    errs = validate_analysis_report(report)
    if errs:
        raise ValueError("invalid analysis report: " + "; ".join(errs))
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
