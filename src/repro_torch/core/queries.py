"""Probability queries (paper §3.5) — the ``prob"lhs | rhs"`` string DSL,
as ``repro.core.queries``.

Julia's string macro becomes a parsed query string plus keyword bindings:

    prob("X = Xnew, y = ynew | w = w0, s = 1.0, model = linreg",
         Xnew=..., ynew=..., w0=..., linreg=linreg_gen)

Grammar:  ``lhs | rhs`` where each side is ``name = expr, ...`` (a bare
``name`` binds the keyword of the same name). ``expr`` is evaluated by a
restricted AST interpreter — names from the keyword bindings, literals,
containers, arithmetic, and attribute access / calls on ``np``/``torch``
only (and their ``linalg``, ``fft``, ``special`` and ``np.random``
submodules, without their file and global-state functions); no builtins,
no arbitrary callables. ``rhs`` must bind ``model``; it may bind
``chain`` (posterior samples: a dict of name -> (M, ...) stacked draws)
for posterior-predictive queries.

Semantics (matching the paper's three examples):
* lhs has only DATA args of the model      -> likelihood p(data | params)
* lhs has only PARAMETER names             -> prior p(params)
* lhs has both                             -> joint p(data, params)
* rhs has ``chain``                        -> posterior predictive
  log( 1/M * sum_i exp(loglike_i) )  computed with logsumexp.

Every query lowers to ONE cached :class:`~repro_torch.core.program.
CompiledProgram` over the flat constrained buffer: parameter values are
packed site by site into the trace's ``FlatLayout`` on the host (one copy
to the device a request, made before the program runs), query-bound data
arrays are program INPUTS (keyed by shape, dtype and device, so requests
with equal shapes and other content share a program — the serving tier
batches on exactly this key), and posterior predictives evaluate all M
draws as one ``torch.func.vmap`` over a stacked ``(M, num_flat)`` buffer
instead of a Python loop. On the card the program is recorded as a CUDA
graph at its second call and replayed after that; a model whose trace
structure depends on drawn values (a dynamic dependency graph) gets an
eager program instead, since a graph would bake one structure.
``prob(..., compiled=False)`` keeps the eager re-execution path (still
vmapped over draws) as the parity oracle.

Arrays (NumPy or tensors) in the bindings are moved to the query's
device; NumPy float64 becomes float32, as ``jnp.asarray`` makes it
without x64.
"""
from __future__ import annotations

import ast
import math
import types
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.contexts import (DefaultContext, LikelihoodContext,
                                       PriorContext)
from repro_torch.core.model import Model, ModelGen
from repro_torch.core.program import (CompiledProgram, ProgramCache,
                                      ProgramKey, data_fingerprint,
                                      model_fingerprint, program_cache)

__all__ = ["PreparedQuery", "parse_query", "prepare_query", "prob"]


def _split_top_level(s: str, sep: str) -> Tuple[str, ...]:
    """Split on ``sep`` outside brackets/parens."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return tuple(p.strip() for p in parts if p.strip())


# ---------------------------------------------------------------------------
# Restricted expression evaluator (no eval, no builtins)
# ---------------------------------------------------------------------------
_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
           ast.Pow: lambda a, b: a ** b, ast.FloorDiv: lambda a, b: a // b,
           ast.Mod: lambda a, b: a % b, ast.MatMult: lambda a, b: a @ b}
_UNARYOPS = {ast.UAdd: lambda a: +a, ast.USub: lambda a: -a}

# the attribute roots and the submodules reachable from them
_MODULES = frozenset({"numpy", "numpy.linalg", "numpy.fft", "numpy.random",
                      "torch", "torch.linalg", "torch.fft", "torch.special"})
# attributes of those modules that touch files, the network or the
# process's global settings
_DENIED = frozenset({
    "load", "loads", "save", "savez", "savez_compressed", "savetxt",
    "loadtxt", "genfromtxt", "fromfile", "tofile", "memmap", "fromregex",
    "set_printoptions", "seterr", "set_default_dtype", "set_default_device",
    "set_default_tensor_type", "set_num_threads", "manual_seed", "seed",
    "use_deterministic_algorithms", "compile", "from_file"})


def _whitelisted_module(obj) -> bool:
    """np/torch and their listed submodules are the only attribute roots."""
    return isinstance(obj, types.ModuleType) and obj.__name__ in _MODULES


def _safe_eval(expr: str, env: Dict[str, Any]):
    """Evaluate a query expression through a restricted AST walk.

    Allowed: literals, names from ``env``, tuple/list display,
    subscripts/slices, unary ±, binary arithmetic, and attribute access
    / calls rooted at the ``np``/``torch`` modules. Everything else —
    lambdas, comprehensions, f-strings, calls to arbitrary objects — and
    the modules' file and global-state functions raise a ``ValueError``
    naming the construct.
    """
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ValueError(
            f"malformed query expression {expr!r}: {e.msg}") from None

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in env:
                raise ValueError(
                    f"unbound name '{node.id}' in query expression "
                    f"{expr!r}; pass it as a keyword binding to prob()")
            return env[node.id]
        if isinstance(node, ast.Attribute):
            base = ev(node.value)
            if not _whitelisted_module(base):
                raise ValueError(
                    f"attribute access on {type(base).__name__!r} is not "
                    f"allowed in query expression {expr!r}; only np/torch "
                    "attributes may be used")
            if node.attr.startswith("_"):
                raise ValueError(
                    f"private attribute '{node.attr}' is not allowed in "
                    f"query expression {expr!r}")
            if node.attr in _DENIED:
                raise ValueError(
                    f"'{base.__name__}.{node.attr}' is not allowed in query "
                    f"expression {expr!r}")
            out = getattr(base, node.attr)
            if isinstance(out, types.ModuleType) and \
                    not _whitelisted_module(out):
                raise ValueError(
                    f"module '{out.__name__}' is not allowed in query "
                    f"expression {expr!r}")
            return out
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Attribute):
                raise ValueError(
                    f"only calls to np.*/torch.* functions are allowed in "
                    f"query expression {expr!r}")
            fn = ev(node.func)
            args = [ev(a) for a in node.args]
            kwargs = {kw.arg: ev(kw.value) for kw in node.keywords
                      if kw.arg is not None}
            if len(kwargs) != len(node.keywords):
                raise ValueError(
                    f"**kwargs unpacking is not allowed in query "
                    f"expression {expr!r}")
            return fn(*args, **kwargs)
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Tuple):
            return tuple(ev(e) for e in node.elts)
        if isinstance(node, ast.List):
            return [ev(e) for e in node.elts]
        if isinstance(node, ast.Subscript):
            return ev(node.value)[ev(node.slice)]
        if isinstance(node, ast.Slice):
            return slice(None if node.lower is None else ev(node.lower),
                         None if node.upper is None else ev(node.upper),
                         None if node.step is None else ev(node.step))
        raise ValueError(
            f"disallowed syntax {type(node).__name__!r} in query "
            f"expression {expr!r}")

    return ev(tree)


def parse_query(spec: str, bindings: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Parse ``"a = e1, b = e2 | c = e3, ..."`` into (lhs, rhs) dicts.

    Malformed specs fail with precise messages: a missing ``|``, an
    empty side, a duplicate name within a side, a non-identifier bare
    item, or a bare name with no matching keyword binding.
    """
    if "|" not in spec:
        raise ValueError("query must contain '|' separating target and given")
    lhs_s, rhs_s = spec.split("|", 1)
    env = {"np": np, "torch": torch}
    env.update(bindings)

    def parse_side(side: str, label: str) -> Dict[str, Any]:
        items = _split_top_level(side, ",")
        if not items:
            raise ValueError(
                f"empty {label} side in query {spec!r}; expected "
                "'name = expr, ...'")
        out: Dict[str, Any] = {}
        for item in items:
            if "=" not in item:
                name = item.strip()
                if not name.isidentifier():
                    raise ValueError(
                        f"malformed item {item!r} on the {label} side of "
                        f"query {spec!r}; expected 'name = expr' or a bare "
                        "bound name")
                if name not in bindings:
                    raise ValueError(
                        f"bare name '{name}' on the {label} side of query "
                        f"{spec!r} has no keyword binding; pass "
                        f"{name}=... to prob()")
                value = bindings[name]
            else:
                name, expr = item.split("=", 1)
                name = name.strip()
                if not name.isidentifier():
                    raise ValueError(
                        f"invalid name {name!r} on the {label} side of "
                        f"query {spec!r}")
                value = _safe_eval(expr.strip(), env)
            if name in out:
                raise ValueError(
                    f"duplicate name '{name}' on the {label} side of "
                    f"query {spec!r}")
            out[name] = value
        return out

    return parse_side(lhs_s, "lhs"), parse_side(rhs_s, "rhs")


def _model_instance(gen_or_model, data_args: Dict[str, Any]) -> Model:
    if isinstance(gen_or_model, Model):
        return gen_or_model.bind(**data_args)
    if isinstance(gen_or_model, ModelGen):
        return gen_or_model(**data_args)
    raise TypeError("rhs 'model =' must be a Model or ModelGen")


def _on_device(v, dev: torch.device):
    """A NumPy array or tensor as a tensor on ``dev`` (NumPy float64 as
    float32); a Python number as a 0-d tensor there (int64 or float32), as
    ``jnp.asarray`` turns one into an array; anything else unchanged."""
    if isinstance(v, (np.ndarray, np.generic)):
        v = torch.as_tensor(np.asarray(v))
        if v.dtype == torch.float64:
            v = v.to(torch.float32)
    elif isinstance(v, bool) or not isinstance(v, (int, float)):
        return v.to(dev) if torch.is_tensor(v) else v
    else:
        v = torch.tensor(v, dtype=torch.float32 if isinstance(v, float)
                         else torch.int64)
    return v.to(dev)


# ---------------------------------------------------------------------------
# Query lowering: spec -> (kind, ctx, model, values/chain split)
# ---------------------------------------------------------------------------
class _LoweredQuery(NamedTuple):
    model: Model          # bound model (incl. query-bound data)
    kind: str             # "prior" | "likelihood" | "joint" | ...
    ctx: Any              # accumulation context for the density
    values: Dict          # constrained parameter values (non-chain kinds)
    chain: Optional[Dict]  # stacked draws (posterior predictive only)
    fixed: Dict           # rhs params fixed alongside the chain
    data_args: Dict       # data bound BY THE QUERY (candidate trace inputs)
    device: torch.device


def _lower(spec: str, bindings: Dict[str, Any], device=None) -> _LoweredQuery:
    dev = resolve_device(device)
    lhs, rhs = parse_query(spec, bindings)
    if "model" not in rhs:
        raise ValueError("query rhs must bind 'model = <model>'")
    gen = rhs.pop("model")
    chain = rhs.pop("chain", None)

    arg_names = set(gen.arg_names if isinstance(gen, ModelGen)
                    else gen.gen.arg_names)

    # split every name into model data-args vs parameter values; arrays
    # (data, and parameter values for the eager path) go to the device
    lhs_data = {k: v for k, v in lhs.items() if k in arg_names}
    lhs_params = {k: v for k, v in lhs.items() if k not in arg_names}
    rhs_data = {k: v for k, v in rhs.items() if k in arg_names}
    rhs_params = {k: v for k, v in rhs.items() if k not in arg_names}

    data_args = {k: (_on_device(v, dev) if isinstance(
        v, (np.ndarray, np.generic, torch.Tensor)) else v)
        for k, v in {**rhs_data, **lhs_data}.items()}
    m = _model_instance(gen, data_args)

    if chain is not None:
        _check_chain(chain)
        return _LoweredQuery(m, "posterior_predictive", LikelihoodContext(),
                             {}, dict(chain), rhs_params, data_args, dev)

    values = {**rhs_params, **lhs_params}
    if lhs_params and not lhs_data:
        ctx, kind = PriorContext(frozenset(lhs_params)), "prior"
    elif lhs_data and not lhs_params:
        ctx, kind = LikelihoodContext(), "likelihood"
    else:
        ctx, kind = DefaultContext(), "joint"
    return _LoweredQuery(m, kind, ctx, values, None, rhs_params, data_args,
                         dev)


def _check_chain(chain: Dict[str, Any]) -> None:
    if not chain:
        raise ValueError("query 'chain' binding is empty; expected a dict "
                         "of name -> (M, ...) stacked draws")
    counts = {n: int(np.shape(v)[0]) if np.ndim(v) else -1
              for n, v in chain.items()}
    if min(counts.values()) < 0:
        bad = [n for n, c in counts.items() if c < 0]
        raise ValueError(f"chain entries {bad} are scalars; every entry "
                         "needs a leading draw axis (M, ...)")
    if len(set(counts.values())) > 1:
        detail = ", ".join(f"'{n}': {c}" for n, c in sorted(counts.items()))
        raise ValueError(
            "chain entries disagree on the number of draws M "
            f"({detail}); all stacked draws must share the leading axis")


# ---------------------------------------------------------------------------
# Flat-buffer packing (host side, per request)
# ---------------------------------------------------------------------------
_FLAT_DTYPE = torch.float32  # matches TypedVarInfo.flat()


def _float32(v, dev: torch.device):
    """A value as float32: a NumPy array when it is on the host (a NumPy
    array, a Python number, a CPU tensor while ``dev`` is not the CPU),
    else a tensor on ``dev``."""
    if torch.is_tensor(v) and v.device == dev:
        return v.detach().to(_FLAT_DTYPE)
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _concat(parts, dev: torch.device, axis: int) -> torch.Tensor:
    """Concatenate on the host with ONE copy to ``dev`` when every part is
    there, else on ``dev``."""
    if all(isinstance(p, np.ndarray) for p in parts):
        return torch.from_numpy(np.ascontiguousarray(
            np.concatenate(parts, axis=axis))).to(dev)
    return torch.cat([p if torch.is_tensor(p)
                      else torch.from_numpy(np.array(p)).to(dev)
                      for p in parts], dim=axis)


def _pack_values(tvi, values: Dict[str, Any],
                 dev: torch.device) -> torch.Tensor:
    """Pack a full constrained values dict into one flat buffer on ``dev``."""
    parts = []
    for s in tvi.layout.sites:
        if s.name not in values:
            raise ValueError(
                f"query must bind a value for parameter site '{s.name}' "
                f"(bound: {sorted(values)})")
        v = _float32(values[s.name], dev)
        try:
            v = (np.broadcast_to(v, s.shape) if isinstance(v, np.ndarray)
                 else torch.broadcast_to(v, s.shape))
        except (ValueError, RuntimeError):
            raise ValueError(
                f"value for site '{s.name}' has shape {tuple(v.shape)}, "
                f"expected broadcastable to {s.shape}") from None
        parts.append(v.reshape((s.size,)))
    if not parts:
        return torch.zeros((0,), dtype=_FLAT_DTYPE, device=dev)
    return _concat(parts, dev, 0)


def _pack_draws(tvi, chain: Dict[str, Any], fixed: Dict[str, Any], M: int,
                dev: torch.device) -> torch.Tensor:
    """Pack M stacked draws (plus fixed values) into an (M, num_flat)
    buffer on ``dev`` — site-ordered blocks, NO per-draw Python loop."""
    parts = []
    for s in tvi.layout.sites:
        if s.name in chain:
            arr = _float32(chain[s.name], dev)
            if tuple(arr.shape[1:]) != s.shape:
                try:
                    arr = (np.broadcast_to(arr, (M,) + s.shape)
                           if isinstance(arr, np.ndarray)
                           else torch.broadcast_to(arr, (M,) + s.shape))
                except (ValueError, RuntimeError):
                    raise ValueError(
                        f"chain draws for '{s.name}' have per-draw shape "
                        f"{tuple(arr.shape[1:])}, expected {s.shape}"
                    ) from None
            parts.append(arr.reshape((M, s.size)))
        elif s.name in fixed:
            v = _float32(fixed[s.name], dev)
            if isinstance(v, np.ndarray):
                v = np.broadcast_to(np.broadcast_to(v, s.shape)
                                    .reshape((1, s.size)), (M, s.size))
            else:
                v = torch.broadcast_to(v, s.shape).reshape(1, s.size) \
                    .expand(M, s.size)
            parts.append(v)
        else:
            raise ValueError(
                f"posterior-predictive query must cover parameter site "
                f"'{s.name}' via the chain or an rhs binding "
                f"(chain: {sorted(chain)}, rhs: {sorted(fixed)})")
    return _concat(parts, dev, 1)


def _split_trace_inputs(data_args: Dict[str, Any]):
    """Query-bound data: arrays become program inputs (keyed on shape,
    dtype and device); scalars and anything structural stays static —
    baked into the program and content-fingerprinted in the key, since
    models may use them for Python-level control flow."""
    traced, static = {}, {}
    for k, v in data_args.items():
        if torch.is_tensor(v) and v.dim() >= 1:
            traced[k] = v
        else:
            static[k] = v
    return traced, static


# ---------------------------------------------------------------------------
# Compiled query programs
# ---------------------------------------------------------------------------
class PreparedQuery(NamedTuple):
    """A query lowered to its cached program + this request's arguments.

    ``program(*args)`` evaluates the query. The serving tier groups
    requests by ``key`` and stacks their ``args`` into one batched
    evaluation (``program.raw`` is the uncaptured per-request function it
    vmaps over).
    """

    key: ProgramKey
    program: CompiledProgram
    args: Tuple
    kind: str
    num_draws: Optional[int] = None


def prepare_query(spec: str, bindings: Dict[str, Any],
                  cache: Optional[ProgramCache] = None,
                  device=None) -> PreparedQuery:
    """Lower a query string to its cached flat-buffer program on
    ``device`` (``None`` means CUDA).

    The cache key is ``(base model fingerprint, "query/<kind>", layout,
    batch, backend, (ctx, static-data fingerprint, traced-data shape
    signature, device))`` — two requests differing only in bound array
    CONTENT share one program; differing shapes/dtypes, contexts, static
    data or devices build separate ones. The layout slot is ``None``, as
    in ``repro``: the model fingerprint and the shape signature fix it.
    """
    cache = cache if cache is not None else program_cache()
    low = _lower(spec, bindings, device)
    dev = low.device
    traced, static = _split_trace_inputs(low.data_args)
    data_names = tuple(sorted(traced))
    data_sig = tuple((n, tuple(traced[n].shape), str(traced[n].dtype))
                     for n in data_names)
    static_fp = tuple(sorted((k, data_fingerprint(v))
                             for k, v in static.items()))
    # the traced data args must NOT be fingerprinted (they are inputs):
    # fingerprint the model with them replaced by None
    base_fp = _model_fp_without(low.model, data_names)
    extra = (low.ctx, static_fp, data_sig, str(dev))

    if low.chain is not None:
        M = int(np.shape(next(iter(low.chain.values())))[0])
        key = ProgramKey(base_fp, "query/posterior_predictive", None, (M,),
                         "fused", extra)
        entry = cache.get_or_build(
            key, lambda: _build_ppd_program(key, low, data_names))
        draws_flat = _pack_draws(entry.template, low.chain, low.fixed, M, dev)
        args = (draws_flat,) + tuple(traced[n] for n in data_names)
        return PreparedQuery(key, entry, args, low.kind, M)

    key = ProgramKey(base_fp, f"query/{low.kind}", None, (), "fused", extra)
    entry = cache.get_or_build(
        key, lambda: _build_query_program(key, low, data_names))
    flat = _pack_values(entry.template, low.values, dev)
    args = (flat,) + tuple(traced[n] for n in data_names)
    return PreparedQuery(key, entry, args, low.kind)


def _model_fp_without(m: Model, traced_names: Tuple[str, ...]) -> Tuple:
    if not traced_names:
        return model_fingerprint(m)
    sentinel = {n: None for n in traced_names}
    return model_fingerprint(m.bind(**sentinel))


def _template_tvi(m: Model, dev: torch.device):
    """Discovery trace fixing the layout the query program addresses.

    Only the layout (shapes/dtypes/supports) is consumed — the drawn
    VALUES are replaced through ``replace_flat`` on every call, so the
    fixed discovery seed cannot bias results."""
    return m.typed_varinfo(torch.Generator(device=dev).manual_seed(0))


def _capturable(m: Model, template) -> bool:
    """Whether the model's trace structure is static (its dependency
    graph is not dynamic): only then may a graph hold its program. This
    is the verdict ``analysis.coverage`` reports for every query kind."""
    from repro_torch.analysis.graph import build_model_graph
    return not build_model_graph(m, template).dynamic


def _bind(base: Model, data_names: Tuple[str, ...], data_vals) -> Model:
    return base.bind(**dict(zip(data_names, data_vals))) if data_names \
        else base


def _build_query_program(key: ProgramKey, low: _LoweredQuery,
                         data_names: Tuple[str, ...]) -> CompiledProgram:
    template = _template_tvi(low.model, low.device)
    base, ctx = low.model, low.ctx

    def raw(flat, *data_vals):
        return _bind(base, data_names, data_vals).logp_with_context(
            template.replace_flat(flat), ctx)

    prog = CompiledProgram(key, raw, jit=_capturable(base, template))
    prog.template = template
    return prog


def _build_ppd_program(key: ProgramKey, low: _LoweredQuery,
                       data_names: Tuple[str, ...]) -> CompiledProgram:
    template = _template_tvi(low.model, low.device)
    base, ctx = low.model, low.ctx
    log_m = math.log(float(key.batch[0]))

    def raw(draws_flat, *data_vals):
        mm = _bind(base, data_names, data_vals)

        def one(flat):
            return mm.logp_with_context(template.replace_flat(flat), ctx)

        lls = torch.func.vmap(one)(draws_flat)
        return torch.logsumexp(lls, dim=0) - log_m

    prog = CompiledProgram(key, raw, jit=_capturable(base, template))
    prog.template = template
    return prog


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def prob(spec: str, *, compiled: bool = True,
         cache: Optional[ProgramCache] = None, device=None,
         **bindings) -> torch.Tensor:
    """Evaluate a probability query on ``device`` (``None`` means CUDA);
    returns the LOG probability (density) as a 0-d tensor there.

    ``compiled=True`` (default) lowers the query to a cached
    :class:`CompiledProgram` over the flat buffer — repeated queries of
    the same shape reuse one program (one CUDA graph on the card), and
    posterior predictives evaluate all M draws in one ``vmap``.
    ``compiled=False`` is the eager re-execution path (parity oracle;
    still vmapped over draws, never a per-draw Python loop).
    """
    if compiled:
        pq = prepare_query(spec, bindings, cache=cache, device=device)
        return pq.program(*pq.args)
    return _prob_eager(spec, bindings, device=device)


def _prob_eager(spec: str, bindings: Dict[str, Any], device=None,
                backend: str = "fused") -> torch.Tensor:
    """The query re-executed eagerly on the typed-free evaluator of
    ``backend``: ``"fused"`` (the kernels' blocks) or ``"reference"``
    (each site's plain ``log_prob``)."""
    low = _lower(spec, bindings, device)
    m, dev = low.model, low.device
    if low.chain is not None:
        # posterior predictive: average likelihood over posterior draws —
        # ONE vmap over the stacked draws, not a Python loop per draw
        stacked = {n: _on_device(v, dev) for n, v in low.chain.items()}
        M = int(next(iter(stacked.values())).shape[0])
        fixed = {n: _on_device(v, dev) for n, v in low.fixed.items()}

        def loglike_one(draw):
            return m.logp_with_context({**draw, **fixed}, LikelihoodContext(),
                                       backend=backend)

        lls = torch.func.vmap(loglike_one)(stacked)
        return torch.logsumexp(lls, dim=0) - math.log(float(M))
    values = {n: _on_device(v, dev) for n, v in low.values.items()}
    return m.logp_with_context(values, low.ctx, backend=backend)
