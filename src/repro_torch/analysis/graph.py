"""ModelGraph — the dependency-graph IR behind ``Model.analyze()``.

The paper's economics is "pay a one-time analysis of the trace, then run
specialised code". This module is that analysis: it replays a model three
times and distils the result into a small graph IR that the lint passes
(``repro_torch.analysis.lints``), the fusion coverage report
(``repro_torch.analysis.coverage``) and the potential compiler
(``repro_torch.core.potential``) all consume, as ``repro.analysis.graph``
does.

1. **Eager structural replay** — a recording ``Evaluator`` subclass runs
   the model once on the typed trace's concrete values and captures every
   tilde site (parameter and observation), ``factor()`` /
   ``prior_factor()`` term and ``reject_if`` condition, in program order,
   with the concrete distribution instances.
2. **Traced dataflow replay** — the same replay under the port's own
   tracer (``analysis.tracer.DependencyTracer``, a ``TorchFunctionMode``
   standing in for ``jax.make_jaxpr``) with every parameter site's stored
   value tagged with its symbol. Forward union-propagation through every
   torch op yields, for every site, WHICH parameter sites each
   distribution-parameter field (read through ``dataclasses.fields``)
   depends on. Python control flow on a random variable surfaces here as
   a :class:`~repro_torch.analysis.tracer.ConcretizationError` and marks
   the graph *dynamic*.
3. **Retrace probe** — the model structure is discovered twice more with
   fresh generators; a diverging site sequence (names/shapes/kinds) also
   marks the graph dynamic (structure depends on drawn values even when
   no host read fires, e.g. value-dependent loop lengths).

Both replays run on the plain (per-site) evaluator with the per-array
switch off and evaluate no site density, so no hand-written kernel and no
``torch.autograd.Function`` ever sees a traced tensor; the discovery runs
of the probe are plain too. Nodes carry the same static metadata the flat
buffer is built from (support, shape, dtype, unconstrained slice from
``FlatLayout``), so a graph verdict always talks about the exact slots the
samplers run on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.tracer import ConcretizationError, DependencyTracer
from repro_torch.core.contexts import Context
from repro_torch.core.interpreters import Evaluator, Sampler
from repro_torch.core.model import Model
from repro_torch.core.varinfo import FlatLayout, TypedVarInfo, typify

__all__ = ["GraphNode", "ModelGraph", "SiteRecord", "build_model_graph"]


@dataclasses.dataclass
class SiteRecord:
    """One recorded event of the eager structural replay (concrete values).

    ``kind`` is ``"param"`` / ``"observed"`` / ``"factor"`` / ``"reject"``.
    ``value`` is the constrained site value for params, the observed data
    for observations, the log-probability term for factors and the
    condition for rejects. ``dist`` is the concrete distribution instance
    (``None`` for factor/reject records).
    """

    kind: str
    name: str
    vn: Any
    dist: Any
    value: Any


@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One site/observation/factor node of the :class:`ModelGraph`.

    ``deps`` lists the parameter-site symbols this node's distribution
    parameters (or factor value) depend on — the parameter-level dataflow
    edges point FROM each dep TO this node. ``field_deps`` breaks the same
    information down per distribution-parameter field (``loc``, ``scale``,
    ...), which is what the conditionally separable compiler needs to
    decide whether an observation attaches to a leaf site.
    """

    name: str
    kind: str                    # "param" | "observed" | "factor" | "reject"
    dist: Optional[str]          # distribution class name
    support: Optional[str]
    shape: Tuple[int, ...]
    dtype: str
    unc_offset: int              # flat unconstrained slice (params; else -1/0)
    unc_size: int
    deps: Tuple[str, ...]
    field_deps: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()

    def field_dep(self, field: str) -> Tuple[str, ...]:
        for f, d in self.field_deps:
            if f == field:
                return d
        return ()


@dataclasses.dataclass
class ModelGraph:
    """Dependency-graph IR of one (model, typed trace) pair."""

    nodes: Tuple[GraphNode, ...]
    layout: FlatLayout
    dynamic_reason: Optional[str]
    duplicates: Tuple[str, ...]
    records: List[SiteRecord]

    def __post_init__(self):
        self._by_name = {n.name: n for n in self.nodes}

    # -- lookups -------------------------------------------------------------
    @property
    def dynamic(self) -> bool:
        return self.dynamic_reason is not None

    def node(self, name: str) -> GraphNode:
        return self._by_name[name]

    def param_nodes(self) -> List[GraphNode]:
        return [n for n in self.nodes if n.kind == "param"]

    def data_nodes(self) -> List[GraphNode]:
        """Observation / factor / reject nodes (everything non-parameter)."""
        return [n for n in self.nodes if n.kind != "param"]

    def edges(self) -> List[Tuple[str, str]]:
        """Parameter-level dataflow edges ``(from_param_sym, to_node)``."""
        return [(dep, n.name) for n in self.nodes for dep in n.deps]

    def dependents(self, sym: str) -> List[GraphNode]:
        return [n for n in self.nodes if sym in n.deps]

    # -- derived structure ----------------------------------------------------
    def coupling_edge(self) -> Optional[Tuple[str, str]]:
        """First edge that breaks full separability, or ``None``.

        Any parameter site feeding another site's distribution parameters
        (including itself, including observations and factors) makes the
        density non-separable coordinate-by-coordinate.
        """
        for n in self.nodes:
            for dep in n.deps:
                return (dep, n.name)
        return None

    def head_syms(self) -> List[str]:
        """Parameter syms that another PARAMETER site's dist params (or a
        factor/reject term) depend on, transitively closed upward (deps of
        heads are heads). These are the coupled "top level" of a
        hierarchy; the complement is the candidate separable-leaf set —
        leaves may still feed observations, which the conditionally
        separable compiler handles via its attach analysis."""
        head = {dep for n in self.nodes if n.kind != "observed"
                for dep in n.deps}
        psyms = {n.name for n in self.param_nodes()}
        head &= psyms
        changed = True
        while changed:
            changed = False
            for n in self.param_nodes():
                if n.name in head:
                    for dep in n.deps:
                        if dep in psyms and dep not in head:
                            head.add(dep)
                            changed = True
        return [n.name for n in self.param_nodes() if n.name in head]

    def reaches_data(self, sym: str) -> bool:
        """Whether ``sym`` has a dataflow path to any observation/factor."""
        seen, frontier = {sym}, [sym]
        while frontier:
            cur = frontier.pop()
            for n in self.dependents(cur):
                if n.kind != "param":
                    return True
                if n.name not in seen:
                    seen.add(n.name)
                    frontier.append(n.name)
        return False

    def __repr__(self):
        e = self.edges()
        return (f"ModelGraph({len(self.param_nodes())} params, "
                f"{len(self.data_nodes())} data nodes, {len(e)} edges"
                + (", dynamic" if self.dynamic else "") + ")")


# ---------------------------------------------------------------------------
# Recording interpreters
# ---------------------------------------------------------------------------
class _RecordingMixin:
    """Capture every tilde/factor/reject event in program order. Site
    densities are not evaluated: the graph records structure and
    dataflow, not values of the log-density."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.site_records: List[SiteRecord] = []
        self._reject_count = 0

    def site_logp(self, dist, value, observed: bool) -> None:
        pass

    def tilde(self, vn, dist, value, observed):
        out = super().tilde(vn, dist, value, observed)
        self.site_records.append(SiteRecord(
            "observed" if observed else "param", str(vn), vn, dist,
            value if observed else out))
        return out

    def factor_site(self, name, logp, observed):
        self.site_records.append(
            SiteRecord("factor", str(name), None, None, logp))
        super().factor_site(name, logp, observed)

    def reject_if(self, cond):
        self._reject_count += 1
        self.site_records.append(SiteRecord(
            "reject", f"_reject_{self._reject_count}", None, None, cond))
        super().reject_if(cond)


class _RecordingEvaluator(_RecordingMixin, Evaluator):
    pass


class _RecordingSampler(_RecordingMixin, Sampler):
    pass


def _dist_fields(dist) -> List[Tuple[str, Any]]:
    if dist is None:
        return []
    return [(f.name, getattr(dist, f.name))
            for f in dataclasses.fields(dist)]


def _shape(v) -> Tuple[int, ...]:
    return tuple(torch.as_tensor(v).shape)


def _dtype(v) -> str:
    return str(torch.as_tensor(v).dtype).replace("torch.", "")


def _trace_field_deps(model: Model, tvi: TypedVarInfo, ctx: Optional[Context]):
    """Map each recorded site to per-field parameter dependencies.

    Returns ``(deps, None)`` on success — ``deps[record_index]`` is a dict
    ``field_name -> frozenset(param_sym)`` (factor/reject records use the
    pseudo-field ``"value"``) — or ``(None, reason)`` when the replay reads
    a traced value on the host (RV-dependent Python control flow).
    """
    tracer = DependencyTracer()
    # fresh tensors, so that two sites sharing storage keep their own tags
    values = tuple(tracer.tag(torch.as_tensor(v).detach().clone(), m.name)
                   for v, m in zip(tvi.values, tvi.metas))
    rec = _RecordingEvaluator(tvi.replace_values(values), ctx=ctx,
                              eager=False)
    try:
        with tracer:
            model._run(rec)
    except ConcretizationError as e:
        first = str(e).splitlines()[0] if str(e) else repr(e)
        return None, ("model structure depends on a traced random "
                      f"variable ({first})")
    deps: List[Dict[str, frozenset]] = []
    for r in rec.site_records:
        if r.kind in ("factor", "reject"):
            deps.append({"value": tracer.deps(r.value)})
        else:
            deps.append({f: tracer.deps(v) for f, v in _dist_fields(r.dist)})
    return deps, None


# ---------------------------------------------------------------------------
# Building the graph
# ---------------------------------------------------------------------------
def _generator(model: Model, generator, device=None) -> torch.Generator:
    """``generator`` itself, or a generator seeded with it (default 0) on
    ``device`` or, when that is ``None``, on the device of the model's
    tensor data (the CPU when it has none)."""
    if isinstance(generator, torch.Generator):
        return generator
    if device is None:
        device = next((v.device for v in model.data.values()
                       if torch.is_tensor(v)), torch.device("cpu"))
    return torch.Generator(device=device).manual_seed(
        0 if generator is None else int(generator))


def _structure_signature(model: Model, generator) -> Optional[Tuple]:
    """Site-structure fingerprint of one fresh discovery run."""
    rec = _RecordingSampler(generator)
    try:
        model._run(rec)
    except Exception:
        return None
    return tuple((r.kind, r.name, _shape(r.value)) for r in rec.site_records)


def build_model_graph(model: Model, tvi: Optional[TypedVarInfo] = None,
                      ctx: Optional[Context] = None,
                      generator=None) -> ModelGraph:
    """Build the :class:`ModelGraph` for ``model`` on trace ``tvi``.

    ``tvi`` may be linked or unlinked (the analysis always replays on the
    constrained trace; the flat-slice metadata on the nodes is the
    UNCONSTRAINED layout the samplers address). When ``tvi`` is omitted a
    discovery run with ``generator`` (a ``torch.Generator`` or an integer
    seed, default 0, where ``repro`` takes a key) supplies it. The retrace
    probe draws from two generators seeded with that generator's initial
    seed plus 101 and 202, on its device.
    """
    from repro_torch.kernels import use_fused_logpdf

    with use_fused_logpdf(False):
        return _build(model, tvi, ctx, generator)


def _build(model, tvi, ctx, generator):
    gen = _generator(model, generator,
                     None if tvi is None else tvi.device)
    if tvi is None:
        tvi = typify(model.untyped_trace(gen))
    if tvi.linked:
        tvi = tvi.invlink()
    layout = tvi.layout

    # 1. eager structural replay (concrete dists + duplicate detection)
    rec = _RecordingEvaluator(tvi, ctx=ctx, eager=False)
    model._run(rec)
    records = rec.site_records

    seen_names: Dict[str, int] = {}
    seen_sym_forms: Dict[str, set] = {}
    duplicates: List[str] = []
    for r in records:
        if r.kind in ("factor", "reject"):
            continue
        seen_names[r.name] = seen_names.get(r.name, 0) + 1
        if seen_names[r.name] == 2:
            duplicates.append(r.name)
        if r.kind == "param":
            forms = seen_sym_forms.setdefault(r.vn.sym, set())
            forms.add("indexed" if r.vn.indexed else "whole")
            if len(forms) == 2 and r.vn.sym not in duplicates:
                duplicates.append(r.vn.sym)

    # 2. traced dataflow replay
    field_deps, dyn_reason = _trace_field_deps(model, tvi, ctx)

    # 3. retrace probe: structure must not move with the drawn values
    if dyn_reason is None:
        base = gen.initial_seed()
        sigs = [_structure_signature(model, torch.Generator(
                    device=gen.device).manual_seed(base + k))
                for k in (101, 202)]
        sigs = [s for s in sigs if s is not None]
        if len(sigs) == 2 and sigs[0] != sigs[1]:
            a = {n for _, n, _ in sigs[0]}
            b = {n for _, n, _ in sigs[1]}
            moved = sorted((a | b) - (a & b)) or ["<shape change>"]
            dyn_reason = ("model structure changed between discovery runs "
                          f"(sites {', '.join(moved)} appear conditionally)")

    # assemble nodes: one per param SYMBOL (grouped element sites merge),
    # one per observation/factor/reject record
    param_acc: Dict[str, Dict[str, frozenset]] = {}
    param_meta: Dict[str, SiteRecord] = {}
    order: List[Tuple[str, Optional[int]]] = []
    for ri, r in enumerate(records):
        fd = field_deps[ri] if (field_deps is not None
                                and ri < len(field_deps)) else {}
        if r.kind == "param":
            sym = r.vn.sym
            if sym not in param_acc:
                param_acc[sym] = {}
                param_meta[sym] = r
                order.append((sym, None))
            acc = param_acc[sym]
            for f, d in fd.items():
                acc[f] = acc.get(f, frozenset()) | d
        else:
            order.append((r.name, ri))

    nodes: List[GraphNode] = []
    for name, ri in order:
        if ri is None:  # param node (grouped element records merged)
            i = tvi.site_index(name)
            meta, sl = tvi.metas[i], layout.sites[i]
            acc = param_acc[name]
            deps = sorted(set().union(*acc.values()) if acc else set())
            d0 = param_meta[name].dist
            nodes.append(GraphNode(
                name=name, kind="param",
                dist=type(d0).__name__ if d0 is not None else None,
                support=meta.support, shape=meta.shape, dtype=meta.dtype,
                unc_offset=sl.unc_offset, unc_size=sl.unc_size,
                deps=tuple(deps),
                field_deps=tuple((f, tuple(sorted(d)))
                                 for f, d in acc.items())))
        else:
            r = records[ri]
            fd = field_deps[ri] if (field_deps is not None
                                    and ri < len(field_deps)) else {}
            deps = sorted(set().union(*fd.values()) if fd else set())
            nodes.append(GraphNode(
                name=name, kind=r.kind,
                dist=type(r.dist).__name__ if r.dist is not None else None,
                support=getattr(r.dist, "support", None),
                shape=_shape(r.value), dtype=_dtype(r.value),
                unc_offset=-1, unc_size=0,
                deps=tuple(deps),
                field_deps=tuple((f, tuple(sorted(d)))
                                 for f, d in fd.items())))

    return ModelGraph(nodes=tuple(nodes), layout=layout,
                      dynamic_reason=dyn_reason,
                      duplicates=tuple(duplicates), records=records)
