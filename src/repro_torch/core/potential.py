"""Compile a model's linked-space log-density to a separable PotentialSpec.

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

The JAX package gates step 1 on a dependency graph built with
``jax.make_jaxpr`` and compiles coupled hierarchies to a conditionally
separable spec. The port has neither yet (ROADMAP.md Queue 1 item 5), so
it takes the branch the JAX package takes when the graph cannot be built:
straight to the probes. Coupled models are therefore rejected by the
validation, and every validation failure says so; the port cannot tell a
conditionally separable model (eight_schools, which the JAX package runs
fused) from any other coupled one.

Returns ``None`` whenever the model is not provably separable; it raises
only when a kernel fails to build or launch. The analysis runs once per run, at sampler setup.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from repro_torch.core.contexts import Context
from repro_torch.core.interpreters import LinkedEvaluator
from repro_torch.core.model import Model
from repro_torch.core.varinfo import TypedVarInfo
from repro_torch.dists.continuous import (Beta, Cauchy, Exponential, Flat,
                                          Gamma, HalfNormal, InverseGamma,
                                          LogNormal, Normal, StudentT,
                                          Uniform)
from repro_torch.dists.multivariate import MvNormalDiag
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.fused_leapfrog.spec import (OP_EXP, OP_NORMAL,
                                                     OP_SOFTPLUS, OP_TLOG,
                                                     OP_ZERO, PotentialSpec)

__all__ = ["build_potential_spec", "compile_potential",
           "PotentialCompileResult"]

_LOG = logging.getLogger("repro_torch.potential")

# appended to every validation failure: without the dependency graph the
# port cannot separate coupled from conditionally separable models
COUPLED_NOTE = ("coupled and conditionally separable models run the "
                "autodiff integrator until ROADMAP.md Queue 1 item 5 (the "
                "dependency graph and the conditional spec)")

_PROBE_SEED = 0


class _NotSeparable(Exception):
    """Density not separable; carries the diagnosis."""

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
    PotentialSpec or None
        ``None`` whenever the density is not separable; the caller runs
        the autodiff integrator. :func:`compile_potential` returns the same
        spec plus the diagnosis explaining a ``None``.
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
        raise _NotSeparable(f"{mismatches[0]}; {COUPLED_NOTE}")

    return PotentialSpec(op=op, c0=c[0], c1=c[1], c2=c[2], c3=c[3],
                         const=float(const), dim=dim)


@dataclasses.dataclass
class PotentialCompileResult:
    """Outcome of :func:`compile_potential` — spec OR diagnosis, never both.

    ``kind`` is ``"separable"`` when ``spec`` is set; otherwise ``reason``
    says why the fused integrator cannot run this model (``site`` names
    the offending site when known), the string samplers surface as
    ``TransitionKernel.spec_reason``.
    """

    spec: Optional[PotentialSpec] = None
    kind: Optional[str] = None
    reason: Optional[str] = None
    site: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.spec is not None


def compile_potential(model: Model, tvi_linked: TypedVarInfo,
                      ctx: Optional[Context] = None,
                      backend: str = "fused") -> PotentialCompileResult:
    """Compile the linked density to a separable :class:`PotentialSpec`.

    Goes straight to the separable compiler (:func:`_build`) and its probe
    validation, the branch the JAX package takes when its dependency graph
    cannot be built: a coupled model, eight_schools included, comes back
    with ``spec=None`` and a reason that ends with :data:`COUPLED_NOTE`.
    Every failure path records why, except a kernel's: a
    :class:`~repro_torch.kernels._build.KernelError` raised in the probes
    is raised, so a kernel that fails never changes the integrator.
    """
    try:
        spec = _build(model, tvi_linked, ctx, backend)
        return PotentialCompileResult(spec=spec, kind="separable")
    except _NotSeparable as e:
        reason, site = e.reason, e.site
    except KernelError:
        raise  # a kernel that fails in the probes fails the run
    except Exception as e:  # a replay the compiler cannot follow
        reason, site = f"spec compilation failed: {e}", None
    _LOG.debug("potential compile: %s", reason)
    return PotentialCompileResult(reason=reason, site=site)
