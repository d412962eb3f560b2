"""Model-execution interpreters + the tilde primitive dispatch stack.

An explicit interpreter object sits on a stack; the tilde primitive
dispatches to the innermost one. Modes:

* ``Sampler``          — eager discovery run: draws values from an explicit
                         ``torch.Generator``, fills an UntypedVarInfo.
* ``Evaluator``        — replay given CONSTRAINED values; accumulates logp
                         per the active Context.
* ``LinkedEvaluator``  — replay given UNCONSTRAINED values; applies the
                         per-site bijector and accumulates log|det J|
                         (Stan-style HMC space).
* ``FusedEvaluator`` / ``FusedLinkedEvaluator`` — same semantics, but
  fusible same-family sites (Normal/MvNormalDiag, BernoulliLogits,
  Categorical, Gamma, Beta, StudentT, MvNormal) are
  GATHERED during the replay and evaluated afterwards as one flat block
  per family via ``kernels.fused_logpdf.site_block_sum`` — one kernel
  launch per family instead of one logpdf+reduce per site.

Every replay is plain tensor code, so ``torch.func.vmap`` over a leading
chain axis and ``torch.func.grad`` compose with it: the Python-side
gathering (``_site_blocks``, ``accum``) runs once per call and only ever
sees logical (per-chain) shapes.

Early rejection (paper §3.3): ``reject()`` / ``reject_if(cond)``. In eager
mode this aborts the model run; in replay mode the accumulator is masked
to -inf instead (no data-dependent branch, so it stays vmap-able).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.bijectors import bijector_for
from repro_torch.core.contexts import Context, DefaultContext
from repro_torch.core.varinfo import TypedVarInfo, UntypedVarInfo
from repro_torch.core.varname import VarName

__all__ = [
    "Interpreter", "Sampler", "Evaluator", "LinkedEvaluator",
    "FusedEvaluator", "FusedLinkedEvaluator", "EarlyRejectError",
    "current_interpreter", "push_interpreter", "pop_interpreter",
]

_STACK: List["Interpreter"] = []


def current_interpreter() -> "Interpreter":
    if not _STACK:
        raise RuntimeError(
            "no active model interpreter — tilde primitives (sample/observe)"
            " may only be called inside a model execution."
        )
    return _STACK[-1]


def push_interpreter(it: "Interpreter") -> None:
    _STACK.append(it)


def pop_interpreter() -> "Interpreter":
    return _STACK.pop()


class EarlyRejectError(Exception):
    """Raised by reject() in eager mode to shortcut the model run."""


def _total(parts: List[Any]):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class Interpreter:
    """Base: holds the context and the split prior/likelihood accumulators."""

    eager = False

    def __init__(self, ctx: Optional[Context] = None):
        self.ctx = ctx if ctx is not None else DefaultContext()
        self._lp_prior_parts: List[Any] = []
        self._lp_lik_parts: List[Any] = []
        self._override: Optional[Any] = None  # set_logp() escape hatch
        self.deterministics: Dict[str, Any] = {}

    # -- accumulation ----------------------------------------------------------
    def accum(self, lp, observed: bool) -> None:
        (self._lp_lik_parts if observed else self._lp_prior_parts).append(lp)

    def site_logp(self, dist, value, observed: bool) -> None:
        """Accumulate one tilde site's total log-probability.

        The reference implementation evaluates the site immediately
        (``dist.total_log_prob``); the fused evaluators override this to
        gather fusible sites into per-family flat blocks instead.
        """
        self.accum(dist.total_log_prob(value), observed=observed)

    @property
    def logp(self):
        if self._override is not None:
            return self._override
        terms = [w * _total(parts) for w, parts in (
            (self.ctx.prior_weight(), self._lp_prior_parts),
            (self.ctx.likelihood_weight(), self._lp_lik_parts)) if parts]
        return _total(terms) if terms else torch.zeros(())

    def set_logp(self, value) -> None:
        self._override = torch.as_tensor(value, dtype=torch.float32)

    def reject_if(self, cond) -> None:
        if self.eager:
            if bool(cond):
                raise EarlyRejectError()
        else:
            cond = torch.as_tensor(cond)
            self.accum(torch.where(cond, -math.inf, 0.0), observed=False)

    def record_deterministic(self, name: str, value) -> None:
        self.deterministics[name] = value

    def factor_site(self, name: str, logp, observed: bool) -> None:
        """Accumulate a named ``factor()``/``prior_factor()`` term."""
        self.accum(torch.sum(torch.as_tensor(logp)), observed=observed)

    # -- tilde dispatch ----------------------------------------------------------
    def tilde(self, vn: VarName, dist, value, observed: bool):
        raise NotImplementedError


class Sampler(Interpreter):
    """Eager discovery run: draw parameters, fill an UntypedVarInfo."""

    eager = True

    def __init__(self, generator: torch.Generator,
                 vi: Optional[UntypedVarInfo] = None,
                 ctx: Optional[Context] = None, init_strategy: str = "prior"):
        super().__init__(ctx)
        self.generator = generator
        self.vi = vi if vi is not None else UntypedVarInfo()
        self.init_strategy = init_strategy

    def tilde(self, vn: VarName, dist, value, observed: bool):
        name = str(vn)
        if observed:
            if self.ctx.wants_site(vn.sym, True):
                self.accum(dist.total_log_prob(value), observed=True)
            return value
        # parameter site
        if name in self.vi:
            val = self.vi[name]
            self.vi.set(name, val, dist)  # refresh dist (params may change)
        elif self.init_strategy == "uniform":
            # Stan-style init: Uniform(-2, 2) in the UNCONSTRAINED space
            bij = bijector_for(dist)
            unc_shape = bij.unconstrained_shape(dist.shape)
            u = torch.rand(unc_shape, generator=self.generator,
                           device=self.generator.device) * 4.0 - 2.0
            val = bij.forward(u)
            self.vi.set(name, val, dist)
        else:
            val = dist.sample(self.generator)
            self.vi.set(name, val, dist)
        if self.ctx.wants_site(vn.sym, False):
            self.accum(dist.total_log_prob(val), observed=False)
        return val


class Evaluator(Interpreter):
    """Replay with given CONSTRAINED values (dict / Untyped / TypedVarInfo)."""

    def __init__(self, values, ctx: Optional[Context] = None,
                 eager: bool = False):
        super().__init__(ctx)
        self.values = values
        self.eager = eager

    def _lookup(self, vn: VarName):
        if isinstance(self.values, TypedVarInfo):
            return self.values[vn]
        src = self.values
        name = str(vn)
        if hasattr(src, "__contains__") and name in src:
            return src[name]
        if vn.indexed and vn.sym in src:  # element of a stacked value
            arr = src[vn.sym]
            idx = vn.index if len(vn.index) > 1 else vn.index[0]
            return arr[idx]
        raise KeyError(f"no value for site '{name}' in evaluator")

    def tilde(self, vn: VarName, dist, value, observed: bool):
        if observed:
            if self.ctx.wants_site(vn.sym, True):
                self.site_logp(dist, value, observed=True)
            return value
        val = self._lookup(vn)
        if self.ctx.wants_site(vn.sym, False):
            self.site_logp(dist, val, observed=False)
        return val


class LinkedEvaluator(Interpreter):
    """Replay with UNCONSTRAINED values from a linked TypedVarInfo.

    For each parameter site: u -> x = bij.forward(u); accumulate
    dist.log_prob(x) + log|det J(u)| so the density is correct on R^n.
    The bijector is built from the RUNTIME dist instance.
    """

    def __init__(self, tvi: TypedVarInfo, ctx: Optional[Context] = None,
                 eager: bool = False):
        if not tvi.linked:
            raise ValueError("LinkedEvaluator requires a linked TypedVarInfo")
        super().__init__(ctx)
        self.tvi = tvi
        self.eager = eager

    def tilde(self, vn: VarName, dist, value, observed: bool):
        if observed:
            if self.ctx.wants_site(vn.sym, True):
                self.site_logp(dist, value, observed=True)
            return value
        i = self.tvi.site_index(vn.sym)
        u_site = self.tvi.values[i]
        meta = self.tvi.metas[i]
        if vn.indexed and meta.grouped:
            idx = vn.index if len(vn.index) > 1 else vn.index[0]
            u = u_site[idx]
        else:
            u = u_site
        bij = bijector_for(dist)
        x = bij.forward(u)
        if self.ctx.wants_site(vn.sym, False):
            self.site_logp(dist, x, observed=False)
            self.accum(bij.forward_log_det_jacobian(u), observed=False)
        return x


# ---------------------------------------------------------------------------
# Fused flat-buffer evaluation (the log-joint hot path)
# ---------------------------------------------------------------------------
def _f32(v) -> torch.Tensor:
    """A parameter or value as float32. A Python number becomes a CPU
    scalar tensor, which joins device tensors as a kernel argument: no
    host-to-device copy (and so no stream synchronisation) per evaluation."""
    return v.to(torch.float32) if torch.is_tensor(v) else \
        torch.as_tensor(v, dtype=torch.float32)


def _fusible_parts(dist, value):
    """Flatten one fusible tilde site into a family-tagged segment.

    Returns ``(family, family_key, segment, extra_lp)`` where ``segment``
    is a tuple of equal-length 1-D tensors (``(N, C)`` logits and ``(N,)``
    int32 labels for categorical, keyed by ``C``; ``(N, D)`` centred rows
    and a ``(D, D)`` precision for mvnormal_prec, keyed by ``D``) ready to
    be concatenated with other segments of the same family, and
    ``extra_lp`` is an optional scalar accumulated immediately (per-site
    analytic terms that must NOT enter the fused block). Returns ``None``
    when the family has no kernel (the site then evaluates through the
    per-site reference path, as in the JAX package).

    Normal/MvNormalDiag sites are STANDARDISED here: the block carries
    ``z = (x - loc) / scale`` and ``extra_lp`` carries ``-sum(log scale)``,
    so the kernel streams one array instead of three; StudentT sites too,
    with ``df`` beside ``z``. Gamma and Beta sites carry ``(x, a - 1, rate
    or b - 1)``. Each leaves its lgamma normaliser in ``extra_lp``: the
    kernels stream only the terms that depend on the value.
    """
    from repro_torch.dists.continuous import Beta, Gamma, Normal, StudentT
    from repro_torch.dists.discrete import BernoulliLogits, Categorical
    from repro_torch.dists.multivariate import MvNormal, MvNormalDiag

    t = type(dist)
    if t is Normal or t is MvNormalDiag:
        x = _f32(value)
        loc = _f32(dist.loc)
        scale = _f32(dist.scale if t is Normal else dist.scale_diag)
        shape = torch.broadcast_shapes(x.shape, loc.shape, scale.shape)
        z = torch.broadcast_to((x - loc) / scale, shape).reshape(-1)
        return ("std_normal", None, (z,),
                -_broadcast_sum(torch.log(scale), shape))
    if t is BernoulliLogits:
        y = torch.as_tensor(value)
        logits = _f32(dist.logits)
        shape = torch.broadcast_shapes(logits.shape, y.shape)
        seg = (torch.broadcast_to(logits, shape).reshape(-1),
               torch.broadcast_to(y, shape).to(torch.float32).reshape(-1))
        return ("bernoulli_logits", None, seg, None)
    if t is Categorical:
        logits = _f32(dist.logits)
        if logits.dim() < 1:
            return None
        c = logits.shape[-1]
        labels = torch.as_tensor(value)
        if labels.dtype != torch.int32:
            labels = labels.to(torch.int32)
        bshape = torch.broadcast_shapes(logits.shape[:-1], labels.shape)
        seg = (torch.broadcast_to(logits, bshape + (c,)).reshape(-1, c),
               torch.broadcast_to(labels, bshape).reshape(-1))
        return ("categorical_logits", c, seg, None)
    if t is Gamma:
        x = _f32(value)
        a, b = _f32(dist.concentration), _f32(dist.rate)
        shape = torch.broadcast_shapes(x.shape, a.shape, b.shape)
        seg = (torch.broadcast_to(x, shape).reshape(-1),
               _param_block(a - 1.0, shape, x), _param_block(b, shape, x))
        # the kernel streams (a-1) log x - b x; the normaliser goes here
        norm = torch.xlogy(a, b) - torch.lgamma(a)
        return ("gamma", None, seg, _broadcast_sum(norm, shape))
    if t is Beta:
        x = _f32(value)
        a, b = _f32(dist.concentration1), _f32(dist.concentration0)
        shape = torch.broadcast_shapes(x.shape, a.shape, b.shape)
        seg = (torch.broadcast_to(x, shape).reshape(-1),
               _param_block(a - 1.0, shape, x),
               _param_block(b - 1.0, shape, x))
        norm = torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
        return ("beta", None, seg, _broadcast_sum(norm, shape))
    if t is StudentT:
        x = _f32(value)
        df, loc = _f32(dist.df), _f32(dist.loc)
        scale = _f32(dist.scale)
        shape = torch.broadcast_shapes(x.shape, df.shape, loc.shape,
                                       scale.shape)
        z = torch.broadcast_to((x - loc) / scale, shape).reshape(-1)
        seg = (z, _param_block(df, shape, x))
        norm = (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale))
        return ("student_t", None, seg, _broadcast_sum(norm, shape))
    if t is MvNormal:
        tril = _f32(dist.scale_tril)
        if tril.dim() != 2:
            return None  # a batched Cholesky factor: the per-site path
        d = tril.shape[-1]
        x, loc = _f32(value), _f32(dist.loc)
        bshape = torch.broadcast_shapes(x.shape[:-1], loc.shape[:-1]
                                        if loc.dim() >= 1 else ())
        xc = torch.broadcast_to(x - loc, bshape + (d,)).reshape(-1, d)
        linv = torch.linalg.solve_triangular(
            tril, torch.eye(d, dtype=torch.float32, device=tril.device),
            upper=False)
        prec = linv.mT @ linv
        extra = xc.shape[0] * (-torch.sum(torch.log(torch.diagonal(tril)))
                               - 0.5 * d * math.log(2.0 * math.pi))
        return ("mvnormal_prec", d, (xc, prec), extra)
    return None


def _broadcast_sum(v: torch.Tensor, shape) -> torch.Tensor:
    """``sum(broadcast_to(v, shape))``; a scalar folds to ``v * numel``, the
    fold XLA applies to the broadcast sum."""
    if v.dim() == 0:
        return v * math.prod(shape)
    return torch.sum(torch.broadcast_to(v, shape))


def _param_block(p: torch.Tensor, shape, like: torch.Tensor) -> torch.Tensor:
    """A distribution parameter broadcast to ``shape`` and flattened, on
    ``like``'s device. A CPU scalar (a Python number in the model) becomes
    a device fill, not a host-to-device copy, so no evaluation waits for
    the stream."""
    if p.dim() == 0 and p.device != like.device:
        return torch.full((math.prod(shape),), float(p), device=like.device)
    return torch.broadcast_to(p, shape).reshape(-1)


class _FusedAccumMixin:
    """Gather fusible sites into per-family flat blocks during the replay.

    ``site_logp`` defers fusible sites into ``self._site_blocks`` keyed by
    ``(family, family_key, observed)``; reading ``logp`` first flushes every
    block through ``kernels.fused_logpdf.site_block_sum`` — ONE launch per
    (family, observed) pair for the whole model — and then delegates to the
    base accumulator, so context weighting, early rejection and ``factor``
    terms compose exactly as on the reference path.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._site_blocks = {}

    def site_logp(self, dist, value, observed: bool) -> None:
        parts = _fusible_parts(dist, value)
        if parts is None:
            super().site_logp(dist, value, observed)
            return
        family, fkey, seg, extra_lp = parts
        self._site_blocks.setdefault((family, fkey, observed), []).append(seg)
        if extra_lp is not None:
            self.accum(extra_lp, observed=observed)

    def _flush_site_blocks(self) -> None:
        if not self._site_blocks:
            return
        from repro_torch.kernels.fused_logpdf import ops
        blocks, self._site_blocks = self._site_blocks, {}
        for (family, _fkey, observed), segs in blocks.items():
            self.accum(ops.site_block_sum(family, segs), observed=observed)

    @property
    def logp(self):
        self._flush_site_blocks()
        return super().logp


class FusedEvaluator(_FusedAccumMixin, Evaluator):
    """``Evaluator`` with the fused flat-block log-joint backend."""


class FusedLinkedEvaluator(_FusedAccumMixin, LinkedEvaluator):
    """``LinkedEvaluator`` with the fused flat-block log-joint backend."""
