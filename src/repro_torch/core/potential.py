"""Compile a model's linked-space log-density for the fused integrators.

The fused leapfrog kernel (``repro_torch.kernels.fused_leapfrog``) runs
only models whose linked-space density is a sum of independent
per-coordinate terms plus a constant:

    logp(u) = sum_i  v_op[i](u[i]; c[i]) + const

``build_potential_spec`` detects that structure:

1. **Record** — replay the model once through a recording
   ``LinkedEvaluator`` subclass, capturing every tilde site's distribution
   instance (with concrete parameter values) and its slot in the flat
   unconstrained buffer (via the trace's ``FlatLayout``).
2. **Compile** — map each parameter site's (distribution, support) pair to
   one of the 5 elementwise opcodes, folding the link-transform jacobian
   into the coefficients. Sites with no opcode abort compilation.
3. **Const by probing** — everything u-independent (normalisers,
   observed-data likelihood terms, jacobian constants) is one scalar:
   ``const = logdensity(u0) - raw(u0)`` at the recorded point, with
   ``raw`` evaluated in float64.
4. **Validate** — the compiled form is checked against the reference
   log-density (value AND gradient) at two perturbed points, always both
   (five evaluations of the log-density in all). Any hidden
   u-dependence the recorder could not see (distribution parameters that
   depend on other parameters, ``factor()`` terms, observed sites whose
   likelihood moves with u) shows up as a mismatch and the compiler
   returns ``None``: the sampler runs the autodiff integrator.

The dependency graph (``repro_torch.analysis.graph``, built on the port's
own tracer) gates the attempt, as in ``repro``: dynamic structure fails
fast; an edge-free graph goes to the separable compiler above; a coupled
graph goes to the conditionally separable compiler (:func:`_build_cond`),
whose :class:`CondPotentialSpec` keeps a small coupled head under
autodiff of a model replay and the leaves elementwise (eight_schools,
gauss_unknown, a ``mu -> x`` hierarchy). It validates the same way, with
probe points drawn by NumPy from ``_PROBE_SEED``: five evaluations of the
log-density in all, whatever the verdict.

Returns ``None`` whenever the model is not provably (conditionally)
separable; it raises only when a kernel fails to build or launch. The
analysis runs once per run, at sampler setup.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.bijectors import bijector_for
from repro_torch.core.contexts import Context, DefaultContext
from repro_torch.core.interpreters import LinkedEvaluator
from repro_torch.core.model import Model
from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.dists.continuous import (Beta, Cauchy, Exponential, Flat,
                                          Gamma, HalfNormal, InverseGamma,
                                          LogNormal, Normal, StudentT,
                                          Uniform)
from repro_torch.dists.multivariate import MvNormalDiag
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.fused_leapfrog.spec import (
    OP_EXP, OP_NORMAL, OP_SOFTPLUS, OP_TLOG, OP_ZERO, CondPotentialSpec,
    PotentialSpec, cond_potential_value_and_grad)

__all__ = ["build_potential_spec", "compile_potential",
           "PotentialCompileResult"]

_LOG = logging.getLogger("repro_torch.potential")

_PROBE_SEED = 0

# coupled-head budget: the head gradient goes through autodiff of the aux
# replay, so keep the dense block small (eight-schools-style top levels)
_MAX_HEAD = 64


class _NotSeparable(Exception):
    """Density not (conditionally) separable; carries the diagnosis."""

    def __init__(self, reason: str, site: Optional[str] = None):
        super().__init__(reason)
        self.reason = reason
        self.site = site


class _Recorder(LinkedEvaluator):
    """LinkedEvaluator that remembers every tilde site it replays."""

    def __init__(self, tvi: TypedVarInfo, ctx: Optional[Context] = None):
        super().__init__(tvi, ctx=ctx)
        self.records = []

    def tilde(self, vn, dist, value, observed):
        out = super().tilde(vn, dist, value, observed)
        self.records.append((vn, dist, observed))
        return out


def _concrete(x):
    """Parameter value as a concrete numpy float64 array (a tensor inside
    a ``torch.func`` transform aborts)."""
    if torch.is_tensor(x):
        if torch._C._functorch.is_functorch_wrapped_tensor(x):
            raise _NotSeparable("traced distribution parameter")
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _compile_site(dist, shape):
    """(opcode, c0, c1, c2, c3) for one site, params broadcast to ``shape``.

    The opcode potential INCLUDES the link-transform log-jacobian; every
    u-independent piece of the site's density is left out (it lands in the
    probed const). The coefficients are folded in float64 from the float32
    parameters, as in the JAX package.
    """
    def b(v):
        return np.broadcast_to(_concrete(v), shape).astype(np.float64)

    zeros = np.zeros(shape, np.float64)
    ones = np.ones(shape, np.float64)
    t = type(dist)
    if t is Flat:
        return OP_ZERO, zeros, zeros, zeros, zeros
    if t is Normal:
        return OP_NORMAL, b(dist.loc), 1.0 / b(dist.scale), zeros, zeros
    if t is MvNormalDiag:
        return OP_NORMAL, b(dist.loc), 1.0 / b(dist.scale_diag), zeros, zeros
    if t is LogNormal:
        # x = exp(u): -0.5((u-loc)/s)^2 - u + jacobian u => pure Normal in u
        return OP_NORMAL, b(dist.loc), 1.0 / b(dist.scale), zeros, zeros
    if t is HalfNormal:
        # x = exp(u): u - exp(2u)/(2 s^2)
        s = b(dist.scale)
        return OP_EXP, ones, 0.5 / (s * s), 2.0 * ones, zeros
    if t is Gamma:
        # x = exp(u): a u - b exp(u)
        return OP_EXP, b(dist.concentration), b(dist.rate), ones, zeros
    if t is InverseGamma:
        # x = exp(u): -a u - b exp(-u)
        return OP_EXP, -b(dist.concentration), b(dist.rate), -ones, zeros
    if t is Exponential:
        # x = exp(u): u - rate exp(u)
        return OP_EXP, ones, b(dist.rate), ones, zeros
    if t is Beta:
        # x = sigmoid(u): -a softplus(-u) - b softplus(u)
        return (OP_SOFTPLUS, b(dist.concentration1), b(dist.concentration0),
                zeros, zeros)
    if t is Uniform:
        # x = low + w sigmoid(u): density + jacobian = -sp(u) - sp(-u)
        return OP_SOFTPLUS, ones, ones, zeros, zeros
    if t is StudentT:
        return (OP_TLOG, (b(dist.df) + 1.0) / 2.0, 1.0 / b(dist.df),
                b(dist.loc), 1.0 / b(dist.scale))
    if t is Cauchy:
        return OP_TLOG, ones, ones, b(dist.loc), 1.0 / b(dist.scale)
    raise _NotSeparable(f"no opcode for {t.__name__}")


# float64 oracle for const probing + validation (numpy, the same forms as
# kernels.fused_leapfrog.spec)
def _np_softplus(x):
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0)


def _np_value(op, c0, c1, c2, c3, u):
    out = np.zeros_like(u)
    m = op == OP_NORMAL
    z = (u - c0) * c1
    out = np.where(m, -0.5 * z * z, out)
    m = op == OP_EXP
    out = np.where(m, c0 * u - c1 * np.exp(np.where(m, c2 * u, 0.0)), out)
    m = op == OP_SOFTPLUS
    out = np.where(m, -c0 * _np_softplus(-u) - c1 * _np_softplus(u), out)
    m = op == OP_TLOG
    zt = (u - c2) * c3
    out = np.where(m, -c0 * np.log1p(c1 * zt * zt), out)
    return out


def _np_grad(op, c0, c1, c2, c3, u):
    out = np.zeros_like(u)
    out = np.where(op == OP_NORMAL, -(u - c0) * c1 * c1, out)
    m = op == OP_EXP
    out = np.where(m, c0 - c1 * c2 * np.exp(np.where(m, c2 * u, 0.0)), out)

    def sig(x):  # overflow-safe logistic
        e = np.exp(-np.abs(x))
        return np.where(x >= 0.0, 1.0 / (1.0 + e), e / (1.0 + e))

    out = np.where(op == OP_SOFTPLUS, c0 * sig(-u) - c1 * sig(u), out)
    zt = (u - c2) * c3
    out = np.where(op == OP_TLOG,
                   -2.0 * c0 * c1 * zt * c3 / (1.0 + c1 * zt * zt), out)
    return out


def build_potential_spec(model: Model, tvi_linked: TypedVarInfo,
                         ctx: Optional[Context] = None,
                         backend: str = "fused") -> Optional[PotentialSpec]:
    """Compile ``model``'s linked log-density to a :class:`PotentialSpec`.

    Parameters
    ----------
    model : Model
        The bound model.
    tvi_linked : TypedVarInfo
        Linked typed trace fixing the flat-buffer layout (the same one the
        sampler's ``make_logdensity_fn`` is specialised on).
    ctx, backend :
        Passed to the reference log-density used for const probing and
        validation — must match what the sampler will run against.

    Returns
    -------
    PotentialSpec or CondPotentialSpec or None
        ``None`` whenever the density is neither separable nor
        conditionally separable; the caller runs the autodiff integrator.
        :func:`compile_potential` returns the same spec plus the diagnosis
        explaining a ``None``.
    """
    return compile_potential(model, tvi_linked, ctx=ctx,
                             backend=backend).spec


def _build(model, tvi, ctx, backend):
    if not tvi.linked:
        raise ValueError("the potential compiler needs a linked TypedVarInfo")
    layout = tvi.layout
    dim = layout.unc_size
    if dim == 0:
        raise _NotSeparable("empty trace")

    rec = _Recorder(tvi, ctx=ctx)
    model._run(rec)

    op = np.full((dim,), OP_ZERO, np.int32)
    c = [np.zeros((dim,), np.float64) for _ in range(4)]
    covered = np.zeros((dim,), bool)

    for vn, dist, observed in rec.records:
        if observed:
            continue  # u-independent terms fold into const; u-dependent
            # ones are caught by validation below
        i = tvi.site_index(vn.sym)
        meta = tvi.metas[i]
        sl = layout.sites[i]
        if meta.support not in ("real", "positive", "unit_interval",
                                "interval"):
            raise _NotSeparable(f"non-elementwise support {meta.support}")
        if vn.indexed and meta.grouped:
            if len(vn.index) != 1 or not isinstance(vn.index[0], int):
                raise _NotSeparable("non-scalar grouped index")
            span = sl.unc_size // meta.nelems
            off = sl.unc_offset + vn.index[0] * span
            shape = meta.shape[1:]
        else:
            off, span, shape = sl.unc_offset, sl.unc_size, sl.unc_shape
        if (int(np.prod(shape)) if shape else 1) != span:
            raise _NotSeparable(f"site '{vn}' shape/span disagree")
        code, c0, c1, c2, c3 = _compile_site(dist, shape)
        if covered[off:off + span].any():
            raise _NotSeparable(f"site '{vn}' written twice")
        op[off:off + span] = code
        for dst, src in zip(c, (c0, c1, c2, c3)):
            dst[off:off + span] = src.ravel()
        covered[off:off + span] = True

    if not covered.all():
        raise _NotSeparable("flat slots not covered by recorded sites")

    # -- const by probing + validation against the reference density --------
    ld = model.make_logdensity_fn(tvi, ctx=ctx, backend=backend)
    dev = tvi.device
    u0 = tvi.flat().detach().cpu().numpy().astype(np.float64)

    def raw(u):
        return float(np.sum(_np_value(op, c[0], c[1], c[2], c[3], u)))

    def on_device(u):
        return torch.as_tensor(u, dtype=torch.float32, device=dev)

    v0 = float(ld(on_device(u0)))
    if not np.isfinite(v0):
        raise _NotSeparable("non-finite log-density at the recorded point")
    const = v0 - raw(u0)

    # both probe points are always evaluated (5 evaluations in all, so the
    # work does not depend on the verdict); the first mismatch is reported
    gen = torch.Generator().manual_seed(_PROBE_SEED)
    mismatches = []
    for k in (1, 2):
        du = torch.randn(dim, generator=gen, dtype=torch.float64).numpy()
        u = u0 + 0.5 * du
        uj = on_device(u)
        vr = float(ld(uj))
        vs = raw(u) + const
        gr = torch.func.grad(ld)(uj).detach().cpu().numpy().astype(np.float64)
        gs = _np_grad(op, c[0], c[1], c[2], c[3], u)
        if not np.isfinite(vr) or abs(vs - vr) > 1e-3 * (1.0 + abs(vr)):
            mismatches.append(f"value mismatch at probe point {k} of 2")
        elif not np.allclose(gs, gr, rtol=2e-3, atol=2e-3):
            mismatches.append(f"gradient mismatch at probe point {k} of 2")
    if mismatches:
        raise _NotSeparable(mismatches[0])

    return PotentialSpec(op=op, c0=c[0], c1=c[1], c2=c[2], c3=c[3],
                         const=float(const), dim=dim)


# ---------------------------------------------------------------------------
# Conditionally separable compiler (coupled head + separable leaves)
# ---------------------------------------------------------------------------
# Leaf priors must compile to an opcode whose coefficients may be
# functions of the head. Keyed by distribution CLASS NAME so the graph
# gate can pre-filter without instantiating anything.
_COND_LEAF_FAMILIES = frozenset([
    "Flat", "Normal", "MvNormalDiag", "LogNormal", "HalfNormal", "Gamma",
    "InverseGamma", "Exponential", "Beta", "Uniform", "StudentT", "Cauchy",
])

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _on(v, dev) -> torch.Tensor:
    """A distribution parameter or datum as a float32 tensor on ``dev``. A
    number (or a CPU scalar) becomes a device fill, not a host-to-device
    copy, so that a captured transition can replay it."""
    if torch.is_tensor(v) and (v.device == dev or v.dim() > 0):
        return v.to(dtype=torch.float32, device=dev)
    if torch.is_tensor(v) or isinstance(v, (int, float, np.number)):
        return torch.full((), float(v), dtype=torch.float32, device=dev)
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def _coef(v, shape, dev) -> torch.Tensor:
    """:func:`_on` of ``v``, broadcast to ``shape``."""
    return torch.broadcast_to(_on(v, dev), shape)


def _compile_site_traced(dist, shape, dev):
    """Traced analogue of :func:`_compile_site`: ``(op, (c0..c3), resid)``.

    Coefficients are float32 tensors on ``dev`` broadcast to ``shape`` and
    MAY be functions of the head block (under ``torch.func`` transforms);
    ``resid`` is the site's normaliser — u-independent in the LEAF
    coordinate but possibly head-dependent (e.g. ``-log tau`` of an
    eight-schools ``theta`` prior), summed over the site.
    """
    def b(v):
        return _coef(v, shape, dev)

    zeros = torch.zeros(shape, device=dev)
    ones = torch.ones(shape, device=dev)
    zero = torch.zeros((), device=dev)
    t = type(dist)
    if t is Flat:
        return OP_ZERO, (zeros, zeros, zeros, zeros), zero
    if t in (Normal, MvNormalDiag, LogNormal):
        s = b(dist.scale_diag if t is MvNormalDiag else dist.scale)
        loc = b(dist.loc)
        resid = -torch.sum(torch.log(s)) - _HALF_LOG_2PI * s.numel()
        return OP_NORMAL, (loc, 1.0 / s, zeros, zeros), resid
    if t is HalfNormal:
        s = b(dist.scale)
        resid = torch.sum(0.5 * math.log(2.0 / math.pi) - torch.log(s))
        return OP_EXP, (ones, 0.5 / (s * s), 2.0 * ones, zeros), resid
    if t is Gamma:
        a, r = b(dist.concentration), b(dist.rate)
        resid = torch.sum(torch.xlogy(a, r) - torch.lgamma(a))
        return OP_EXP, (a, r, ones, zeros), resid
    if t is InverseGamma:
        a, r = b(dist.concentration), b(dist.rate)
        resid = torch.sum(torch.xlogy(a, r) - torch.lgamma(a))
        return OP_EXP, (-a, r, -ones, zeros), resid
    if t is Exponential:
        r = b(dist.rate)
        return OP_EXP, (ones, r, ones, zeros), torch.sum(torch.log(r))
    if t is Beta:
        a, c = b(dist.concentration1), b(dist.concentration0)
        resid = torch.sum(torch.lgamma(a + c) - torch.lgamma(a)
                          - torch.lgamma(c))
        return OP_SOFTPLUS, (a, c, zeros, zeros), resid
    if t is Uniform:
        # -log(width) normaliser cancels against the sigmoid-link
        # jacobian's +log(width); what is left is exactly SOFTPLUS(1, 1)
        return OP_SOFTPLUS, (ones, ones, zeros, zeros), zero
    if t is StudentT:
        df, s = b(dist.df), b(dist.scale)
        resid = torch.sum(torch.lgamma(0.5 * (df + 1.0))
                          - torch.lgamma(0.5 * df)
                          - 0.5 * torch.log(df * math.pi) - torch.log(s))
        return (OP_TLOG, ((df + 1.0) / 2.0, 1.0 / df, b(dist.loc), 1.0 / s),
                resid)
    if t is Cauchy:
        s = b(dist.scale)
        resid = torch.sum(-math.log(math.pi) - torch.log(s))
        return OP_TLOG, (ones, ones, b(dist.loc), 1.0 / s), resid
    raise _NotSeparable(f"no traced opcode for {t.__name__}")


def _attach_normal(dist, value, leaf_unc_shape, dev):
    """Completed-square coefficients of a Normal observation on a leaf.

    The observation ``y ~ Normal(x_leaf, s)`` (``y`` possibly carrying
    extra leading axes that broadcast over the leaf — repeated
    measurements) collapses, per leaf coordinate, to

        -0.5 * ((u - b0) * b1)^2 + resid

    with ``b1 = sqrt(sum_r 1/s^2)`` (precision aggregate), ``b0`` the
    precision-weighted data mean and ``resid`` the leftover data-only
    quadratic plus the Gaussian normalisers. Exact — no approximation; in
    float32, as ``repro`` computes it.
    """
    y, s = _on(value, dev), _on(dist.scale, dev)
    shape = tuple(torch.broadcast_shapes(y.shape, s.shape, leaf_unc_shape))
    n_l = int(np.prod(leaf_unc_shape)) if leaf_unc_shape else 1
    n_tot = int(np.prod(shape)) if shape else 1
    if leaf_unc_shape and \
            shape[len(shape) - len(leaf_unc_shape):] != tuple(leaf_unc_shape):
        raise _NotSeparable(
            "observation shape does not broadcast over the leaf")
    yb = torch.broadcast_to(y, shape).reshape(-1, n_l)
    sb = torch.broadcast_to(s, shape).reshape(-1, n_l)
    w = 1.0 / (sb * sb)
    prec = torch.sum(w, dim=0)
    mean = torch.sum(w * yb, dim=0) / prec
    resid = (-0.5 * (torch.sum(w * yb * yb) - torch.sum(prec * mean * mean))
             - torch.sum(torch.log(sb)) - _HALF_LOG_2PI * n_tot)
    return mean, torch.sqrt(prec), resid


class _CondRecorder(LinkedEvaluator):
    """LinkedEvaluator that treats a designated leaf set symbolically.

    Head sites replay normally — their prior + jacobian terms accumulate
    into the interpreter logp, which becomes the spec's residual. Leaf
    sites return their RECORDED constrained constants and instead record
    opcode coefficients; Normal observations whose ``loc`` is exactly a
    leaf's value are captured as completed-square attach terms rather
    than accumulated. Any structure this recorder cannot express lands in
    ``self.failures`` (checked once, on the compile's first run).

    Which observation attaches to which leaf is settled by that first run
    (``attach_map=None``): by identity of ``loc`` with the leaf's value,
    else by equal values read on the host; it is kept in ``self.matched``.
    Every later replay (the spec's ``aux_fn``, under ``torch.func``
    transforms and inside captured transitions) is given that map and
    reads nothing on the host.
    """

    def __init__(self, tvi, ctx, leaf_syms, attach_map=None):
        super().__init__(tvi, ctx=ctx, eager=False)
        self.leaf_syms = frozenset(leaf_syms)
        self.attach_map = attach_map
        self.matched = {}       # observation name -> leaf sym
        self.leaf_coeffs = {}   # sym -> (op, (c0..c3), resid)
        self.leaf_consts = []   # (sym, constrained constant) in visit order
        self.attach = {}        # sym -> (b0, b1, resid)
        self.failures = []

    def tilde(self, vn, dist, value, observed):
        if observed:
            return self._observed(vn, dist, value)
        if vn.sym not in self.leaf_syms:
            return super().tilde(vn, dist, value, observed)
        if vn.indexed:
            self.failures.append(f"leaf site '{vn}' is index-grouped")
        if vn.sym in self.leaf_coeffs:
            self.failures.append(f"leaf site '{vn.sym}' replayed twice")
        i = self.tvi.site_index(vn.sym)
        u = self.tvi.values[i]
        x = bijector_for(dist).forward(u)
        try:
            self.leaf_coeffs[vn.sym] = _compile_site_traced(
                dist, tuple(u.shape), u.device)
        except _NotSeparable as e:
            self.failures.append(f"leaf '{vn.sym}': {e.reason}")
        self.leaf_consts.append((vn.sym, x))
        return x

    def _match_leaf(self, loc):
        for sym, x in self.leaf_consts:
            if loc is x:
                return sym
        if not torch.is_tensor(loc):
            return None
        for sym, x in self.leaf_consts:
            if (loc.shape == x.shape and loc.device == x.device
                    and bool(torch.equal(loc, x))):
                return sym
        return None

    def _observed(self, vn, dist, value):
        if not self.ctx.wants_site(vn.sym, True):
            return value
        name = str(vn)
        if type(dist) is not Normal:
            sym = None
        elif self.attach_map is not None:
            sym = self.attach_map.get(name)
        else:
            sym = self._match_leaf(dist.loc)
            if sym is not None:
                self.matched[name] = sym
        if sym is None:
            self.site_logp(dist, value, observed=True)
            return value
        if sym in self.attach:
            self.failures.append(
                f"leaf '{sym}' has multiple observation attachments")
            return value
        i = self.tvi.site_index(sym)
        try:
            self.attach[sym] = _attach_normal(
                dist, value, tuple(self.tvi.values[i].shape),
                self.tvi.values[i].device)
        except _NotSeparable as e:
            self.failures.append(f"observation '{vn}': {e.reason}")
        return value


def _build_cond(model, tvi, ctx, backend, graph):
    """Compile a coupled hierarchy to a :class:`CondPotentialSpec`.

    Partition = graph heads (+ any leaf whose prior family/support the
    traced opcode table cannot express, promoted into the head where the
    generic replay handles it); the remaining leaves must only feed
    observations, and only as attachable Normal locations.
    """
    if not tvi.linked:
        raise ValueError("the potential compiler needs a linked TypedVarInfo")
    if ctx is not None and type(ctx) is not DefaultContext:
        raise _NotSeparable(
            "conditional spec requires the default context")
    layout = tvi.layout
    dim = layout.unc_size
    if dim == 0:
        raise _NotSeparable("empty trace")
    pnodes = {n.name: n for n in graph.param_nodes()}
    head = set(graph.head_syms())

    leaf = []
    for m in tvi.metas:
        node = pnodes.get(m.name)
        if node is None:
            raise _NotSeparable(f"site '{m.name}' missing from graph")
        if m.name in head:
            continue
        if (m.support in ("real", "positive", "unit_interval", "interval")
                and not m.grouped and node.dist in _COND_LEAF_FAMILIES):
            leaf.append(m.name)
        else:
            head.add(m.name)  # generic replay covers it
    if not leaf:
        raise _NotSeparable("no separable leaf block given the head")
    leafset = set(leaf)

    head_sites = [i for i, m in enumerate(tvi.metas) if m.name in head]
    leaf_sites = [i for i, m in enumerate(tvi.metas) if m.name in leafset]
    head_size = sum(layout.sites[i].unc_size for i in head_sites)
    if head_size > _MAX_HEAD:
        raise _NotSeparable(
            f"coupled head too large ({head_size} > {_MAX_HEAD} coords)")

    # graph pre-checks: leaves may ONLY feed attachable Normal observations
    must_attach = {}
    for n in graph.data_nodes():
        ldeps = set(n.deps) & leafset
        if not ldeps:
            continue
        if n.kind != "observed":
            raise _NotSeparable(
                f"{n.kind} term '{n.name}' depends on leaf site(s) "
                f"{sorted(ldeps)}", site=n.name)
        if n.dist != "Normal":
            raise _NotSeparable(
                f"observation '{n.name}' ({n.dist}) depends on leaf "
                f"site(s) {sorted(ldeps)} — only Normal observations "
                "attach", site=n.name)
        (lsym,) = ldeps if len(ldeps) == 1 else (None,)
        if lsym is None:
            raise _NotSeparable(
                f"observation '{n.name}' mixes leaf sites {sorted(ldeps)}",
                site=n.name)
        if set(n.field_dep("scale")) & leafset:
            raise _NotSeparable(
                f"observation '{n.name}' scale depends on leaf '{lsym}'",
                site=n.name)
        if set(n.field_dep("loc")) - {lsym}:
            raise _NotSeparable(
                f"observation '{n.name}' loc mixes leaf '{lsym}' with "
                "other parameters", site=n.name)
        if pnodes[lsym].support != "real":
            raise _NotSeparable(
                f"leaf '{lsym}' has a non-identity link; cannot attach "
                f"observation '{n.name}'", site=lsym)
        if lsym in must_attach:
            raise _NotSeparable(
                f"leaf '{lsym}' has multiple observation attachments",
                site=lsym)
        must_attach[lsym] = n.name

    head_slices = [(layout.sites[i].unc_offset, layout.sites[i].unc_size,
                    layout.sites[i].unc_shape) for i in head_sites]
    leaf_slices = [(layout.sites[i].unc_offset, layout.sites[i].unc_size)
                   for i in leaf_sites]
    idx = np.arange(dim, dtype=np.int32)
    head_idx = (np.concatenate([idx[o:o + s] for o, s, _ in head_slices])
                if head_slices else np.zeros((0,), np.int32))
    leaf_idx = np.concatenate([idx[o:o + s] for o, s in leaf_slices])
    leaf_order = [tvi.metas[i].name for i in leaf_sites]
    leaf_spans = {tvi.metas[i].name: layout.sites[i].unc_size
                  for i in leaf_sites}
    values0 = tvi.values
    dev = tvi.device

    def aux_parts(u_head, attach_map):
        vals = list(values0)
        off = 0
        for i, (_, s, shp) in zip(head_sites, head_slices):
            vals[i] = torch.reshape(u_head[off:off + s], shp)
            off += s
        rec = _CondRecorder(tvi.replace_values(tuple(vals)), ctx, leafset,
                            attach_map)
        model._run(rec)
        resid = rec.logp  # head priors + jacobians, factors, head-only obs
        failures = list(rec.failures)
        cs = ([], [], [], [])
        b0s, b1s, ops_, mask = [], [], [], []
        for sym in leaf_order:
            span = leaf_spans[sym]
            parts = rec.leaf_coeffs.get(sym)
            if parts is None:
                failures.append(f"leaf '{sym}' not replayed")
                parts = (OP_ZERO, (torch.zeros(span, device=dev),) * 4,
                         torch.zeros((), device=dev))
            opc, coeffs, r = parts
            resid = resid + r
            ops_.append(np.full((span,), opc, np.int32))
            for dst, src in zip(cs, coeffs):
                dst.append(torch.reshape(src, (-1,)))
            at = rec.attach.get(sym)
            if at is None:
                if sym in must_attach:
                    failures.append(
                        f"observation '{must_attach[sym]}' did not match "
                        f"leaf '{sym}' (loc is not the leaf value)")
                b0s.append(torch.zeros(span, device=dev))
                b1s.append(torch.zeros(span, device=dev))
                mask.append(np.zeros(span, bool))
            else:
                b0, b1, ar = at
                resid = resid + ar
                b0s.append(torch.reshape(b0, (-1,)))
                b1s.append(torch.reshape(b1, (-1,)))
                mask.append(np.ones(span, bool))
        dyn = (tuple(torch.cat(d) for d in cs)
               + (torch.cat(b0s), torch.cat(b1s), resid))
        return dyn, (np.concatenate(ops_), np.concatenate(mask), failures,
                     rec.matched)

    u0 = tvi.flat().detach().cpu().numpy().astype(np.float64)

    def on_device(u):
        return torch.as_tensor(u, dtype=torch.float32, device=dev)

    _, (opA, attach_mask, failures, matched) = aux_parts(
        on_device(u0[head_idx]), None)
    if failures:
        raise _NotSeparable(failures[0])

    def aux_fn(u_head):
        return aux_parts(u_head, matched)[0]

    spec = CondPotentialSpec(
        head_idx=head_idx, leaf_idx=leaf_idx, opA=opA,
        attach_mask=attach_mask, aux_fn=aux_fn, const=0.0, dim=dim,
        head_syms=tuple(tvi.metas[i].name for i in head_sites))

    # -- const by probing + validation against the reference density --------
    ld = model.make_logdensity_fn(tvi, ctx=ctx, backend=backend)
    v0 = float(ld(on_device(u0)))
    s0 = float(cond_potential_value_and_grad(spec, on_device(u0))[0])
    if not (np.isfinite(v0) and np.isfinite(s0)):
        raise _NotSeparable("non-finite log-density at the recorded point")
    spec = dataclasses.replace(spec, const=float(v0 - s0))

    # both probe points are always evaluated (5 evaluations of the
    # log-density in all, whatever the verdict); the first mismatch is
    # reported
    rng = np.random.default_rng(_PROBE_SEED)
    mismatches = []
    for k in (1, 2):
        uj = on_device(u0 + 0.5 * rng.standard_normal(dim))
        vr = float(ld(uj))
        vs, gs = cond_potential_value_and_grad(spec, uj)
        gr = torch.func.grad(ld)(uj).detach().cpu().numpy().astype(np.float64)
        gs = gs.detach().cpu().numpy().astype(np.float64)
        vs = float(vs)
        if not np.isfinite(vr) or abs(vs - vr) > 1e-3 * (1.0 + abs(vr)):
            mismatches.append(f"value mismatch at probe point {k} of 2")
        elif not np.allclose(gs, gr, rtol=2e-3, atol=2e-3):
            mismatches.append(f"gradient mismatch at probe point {k} of 2")
    if mismatches:
        raise _NotSeparable(mismatches[0])
    return spec


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PotentialCompileResult:
    """Outcome of :func:`compile_potential` — spec OR diagnosis, never both.

    ``kind`` is ``"separable"`` / ``"conditional"`` when ``spec`` is set;
    otherwise ``reason`` says exactly why the fused integrator cannot run
    this model (and ``site`` names the offending site when known) — the
    same string samplers surface as ``TransitionKernel.spec_reason``.
    """

    spec: object = None
    kind: Optional[str] = None
    reason: Optional[str] = None
    site: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.spec is not None


def compile_potential(model: Model, tvi_linked: TypedVarInfo,
                      ctx: Optional[Context] = None,
                      backend: str = "fused",
                      allow_conditional: bool = True
                      ) -> PotentialCompileResult:
    """Compile the linked density to the best available fused form.

    The dependency graph (``repro_torch.analysis.graph``) gates the
    attempt: dynamic structure fails fast with the lint's reason; a fully
    edge-free graph goes to the separable compiler (:func:`_build`); a
    coupled graph goes to the conditionally separable compiler
    (:func:`_build_cond`), or, with ``allow_conditional=False``, comes
    back as ``coupled parameters: ...``. Every failure path records why,
    except a kernel's: a :class:`~repro_torch.kernels._build.KernelError`
    raised in the graph build or the probes is raised, so a kernel that
    fails never changes the integrator.
    """
    graph, graph_reason = None, None
    try:
        # routed through the ProgramCache: Model.analyze() and repeated
        # sampler setups on the same (model, layout, ctx) share ONE graph
        # build — the graph's own replay probes are the expensive part
        from repro_torch.core.program import model_graph
        graph = model_graph(model, tvi_linked, ctx=ctx)
    except KernelError:
        raise
    except Exception as e:  # graph failure: fall through to probing
        graph_reason = f"dependency-graph construction failed: {e}"
    if graph is not None and graph.dynamic:
        reason = f"dynamic model structure: {graph.dynamic_reason}"
        _LOG.debug("potential compile: %s", reason)
        return PotentialCompileResult(reason=reason)

    edge = graph.coupling_edge() if graph is not None else None
    if edge is None:
        try:
            spec = _build(model, tvi_linked, ctx, backend)
            return PotentialCompileResult(spec=spec, kind="separable")
        except _NotSeparable as e:
            reason, site = e.reason, e.site
        except KernelError:
            raise  # a kernel that fails in the probes fails the run
        except Exception as e:  # a replay the compiler cannot follow
            reason, site = f"spec compilation failed: {e}", None
        if graph_reason is not None:
            reason = f"{reason} ({graph_reason})"
        _LOG.debug("potential compile: %s", reason)
        return PotentialCompileResult(reason=reason, site=site)

    dep, tgt = edge
    cause = f"site '{tgt}' depends on parameter '{dep}'"
    if not allow_conditional:
        return PotentialCompileResult(
            reason=f"coupled parameters: {cause}", site=tgt)
    try:
        spec = _build_cond(model, tvi_linked, ctx, backend, graph)
        return PotentialCompileResult(spec=spec, kind="conditional")
    except _NotSeparable as e:
        reason, site = e.reason, e.site or tgt
    except KernelError:
        raise
    except Exception as e:
        reason, site = str(e), tgt
    reason = f"coupled ({cause}); conditional compile failed: {reason}"
    _LOG.debug("potential compile: %s", reason)
    return PotentialCompileResult(reason=reason, site=site)
