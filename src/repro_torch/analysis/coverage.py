"""Fusion coverage: which fused kernel families each site actually hits.

Two independent fusion layers exist, and this module reports both per
site, with the precise fallback reason when a site misses one:

* **fused_logpdf** — the flat-block log-joint families gathered by
  ``FusedEvaluator`` (``std_normal``, ``gamma``, ...). The classifier IS
  ``repro_torch.core.interpreters._fusible_parts`` — the same function the
  evaluator calls at runtime — so the report cannot drift from what the
  hot path actually selects.
* **fused_leapfrog** — the opcode the potential compiler assigns the
  site in a (conditionally-)separable spec, plus the site's role
  (``separable`` coordinate, coupled ``head``, analytic ``leaf``), and
  the model-level verdict from ``compile_potential`` explaining why
  ``leapfrog="auto"`` will or will not run fused. A separable spec runs
  the ``fused_leapfrog`` CUDA kernel; a conditional one runs plain torch
  on every device (its head term replays model code), as in ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.analysis.graph import ModelGraph
from repro_torch.core.model import Model
from repro_torch.core.varinfo import TypedVarInfo

__all__ = ["SiteCoverage", "QueryCoverage", "CoverageReport",
           "fusion_coverage", "OP_NAMES"]

OP_NAMES = {0: "ZERO", 1: "NORMAL", 2: "EXP", 3: "SOFTPLUS", 4: "TLOG"}


@dataclasses.dataclass(frozen=True)
class SiteCoverage:
    """Per-site fusion verdicts across both kernel layers."""

    name: str
    kind: str                          # "param" | "observed" | "factor" | ...
    dist: Optional[str]
    fused_family: Optional[str]        # fused_logpdf block family
    fused_reason: Optional[str]        # why not, when family is None
    leapfrog_op: Optional[str]         # opcode name in a potential spec
    leapfrog_role: Optional[str]       # "separable" | "head" | "leaf" | None
    leapfrog_reason: Optional[str]     # why not, when op/role is None


@dataclasses.dataclass(frozen=True)
class QueryCoverage:
    """Per-query-kind lowering verdict: compiled program or eager trace."""

    kind: str                          # "prior" | "likelihood" | "joint" | ...
    path: str                          # "compiled" | "eager"
    reason: Optional[str]              # why eager, when path == "eager"


@dataclasses.dataclass
class CoverageReport:
    """Model-level fusion coverage: per-site table + compile verdict."""

    model: str
    potential_kind: Optional[str]      # "separable" | "conditional" | None
    potential_reason: Optional[str]
    potential_site: Optional[str]
    sites: Tuple[SiteCoverage, ...]
    queries: Tuple[QueryCoverage, ...] = ()

    def site(self, name: str) -> SiteCoverage:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(name)


def _fused_family(dist, value) -> Tuple[Optional[str], Optional[str]]:
    """(family, reason-if-none) — delegates to the runtime classifier."""
    from repro_torch.core.interpreters import _fusible_parts
    if dist is None:
        return None, "factor/reject terms accumulate directly"
    try:
        parts = _fusible_parts(dist, value)
    except Exception as e:  # defensive: classifier never saw this shape
        return None, f"classifier failed: {e}"
    if parts is None:
        return None, (f"no fused_logpdf kernel for "
                      f"{type(dist).__name__}; per-site reference path")
    return parts[0], None


def _leapfrog_site(dist, meta) -> Tuple[Optional[str], Optional[str]]:
    """(opcode name, reason-if-none) for one parameter site's prior."""
    from repro_torch.core.potential import _NotSeparable, _compile_site
    if meta.support not in ("real", "positive", "unit_interval", "interval"):
        return None, (f"support '{meta.support}' has no elementwise "
                      "unconstrained transform")
    try:
        code = _compile_site(dist, meta.unc_shape)[0]
    except _NotSeparable as e:
        return None, e.reason
    except Exception as e:
        return None, str(e)
    return OP_NAMES.get(int(code), str(code)), None


def fusion_coverage(model: Model, graph: ModelGraph,
                    tvi: Optional[TypedVarInfo] = None) -> CoverageReport:
    """Build the per-site fusion coverage table for ``model``.

    ``tvi`` is the (constrained or linked) typed trace the graph was
    built on; when omitted the graph's own records/layout suffice for
    the per-site columns but the model-level potential verdict requires
    a linkable trace (discrete sites report the link failure instead).
    """
    from repro_torch.core.program import cached_potential

    kind = reason = vsite = None
    spec = None
    if tvi is not None:
        try:
            res = cached_potential(model, tvi.link())
            kind, reason, vsite, spec = (res.kind, res.reason, res.site,
                                         res.spec)
        except ValueError as e:  # link() refuses discrete sites
            reason = str(e)
    else:
        reason = "no typed trace supplied; potential verdict skipped"

    head_syms = set(getattr(spec, "head_syms", ()) or ())
    by_sym = {}
    for r in graph.records:
        if r.kind == "param" and r.vn.sym not in by_sym:
            by_sym[r.vn.sym] = r

    sites: List[SiteCoverage] = []
    for n in graph.nodes:
        if n.kind == "param":
            rec = by_sym.get(n.name)
            meta = None
            if tvi is not None:
                meta = tvi.metas[tvi.site_index(n.name)]
            fam, fam_why = (_fused_family(rec.dist, rec.value)
                            if rec is not None else (None, "not replayed"))
            if meta is not None and rec is not None:
                op, op_why = _leapfrog_site(rec.dist, meta)
            else:
                op, op_why = None, "no typed trace supplied"
            if kind == "separable":
                role = "separable" if op is not None else None
            elif kind == "conditional":
                role = "head" if n.name in head_syms else "leaf"
                if role == "head":
                    # head coordinates replay generically; the opcode
                    # column is about the LEAF table
                    op, op_why = None, "coupled head: generic replay"
            else:
                role = None
                if op_why is None:
                    op_why = reason
            sites.append(SiteCoverage(
                name=n.name, kind=n.kind, dist=n.dist,
                fused_family=fam, fused_reason=fam_why,
                leapfrog_op=op, leapfrog_role=role, leapfrog_reason=op_why))
        else:
            rec = next((r for r in graph.records if r.name == n.name
                        and r.kind == n.kind), None)
            fam, fam_why = (_fused_family(rec.dist, rec.value)
                            if rec is not None else (None, "not replayed"))
            sites.append(SiteCoverage(
                name=n.name, kind=n.kind, dist=n.dist,
                fused_family=fam, fused_reason=fam_why,
                leapfrog_op=None, leapfrog_role=None,
                leapfrog_reason="data terms fold into the spec const "
                                "or attach/residual"))
    # Per-query-kind lowering verdict: every `prob` query kind lowers to one
    # cached jitted program over the flat buffer unless the model's trace
    # structure is value-dependent, in which case queries fall back to the
    # eager per-call trace.
    if graph.dynamic:
        q_path, q_reason = "eager", graph.dynamic_reason
    else:
        q_path, q_reason = "compiled", None
    queries = tuple(
        QueryCoverage(kind=k, path=q_path, reason=q_reason)
        for k in ("prior", "likelihood", "joint", "posterior_predictive"))

    return CoverageReport(model=model.name, potential_kind=kind,
                          potential_reason=reason, potential_site=vsite,
                          sites=tuple(sites), queries=queries)
