"""User-facing tilde primitives: sample / observe / tilde / reject / ...

These are the DSL surface corresponding to DynamicPPL's ``~`` / ``.~``
notation, `@logpdf() = -Inf` early rejection, and deterministic recording.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.interpreters import current_interpreter
from repro_torch.core.varname import VarName

__all__ = [
    "missing", "sample", "observe", "tilde", "reject", "reject_if",
    "set_logp", "get_logp", "deterministic", "factor", "prior_factor",
    "submodel",
]


class _Missing:
    """Sentinel mirroring Julia's ``missing`` (auto param/data split)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "missing"

    def __bool__(self):
        return False


missing = _Missing()


def _is_missing(v: Any) -> bool:
    return v is missing or v is None


_PREFIX_STACK = []


def tilde(name: str, dist, value: Any = missing):
    """``value ~ dist``. Data if ``value`` given, parameter if missing.

    This implements the paper's automatic parameter/data determination: a
    model argument with a concrete value is an observation at its tilde
    site; ``missing`` (or None) makes the site a model parameter to infer.
    """
    full = "".join(_PREFIX_STACK) + str(name)
    vn = VarName.parse(full)
    it = current_interpreter()
    observed = not _is_missing(value)
    return it.tilde(vn, dist, value if observed else None, observed)


def submodel(name: str, m):
    """Run another model INSIDE the current one (compositional modelling —
    the paper's §5 future work, delivered). Every tilde site of ``m`` is
    recorded under the prefix ``"<name>."`` in the CURRENT trace, so one
    typed trace covers the whole composite and inference sees a single
    flat parameter vector. Returns the inner model's return value.

        @model
        def prior_block():
            return sample("w", Normal(0.0, 1.0))

        @model
        def top(y):
            w = submodel("block", prior_block())
            observe("y", Normal(w, 1.0), y)
    """
    _PREFIX_STACK.append(f"{name}.")
    try:
        return m.gen.fn(**m.data)
    finally:
        _PREFIX_STACK.pop()


def sample(name: str, dist):
    """A parameter tilde site: ``name ~ dist``."""
    return tilde(name, dist, missing)


def observe(name: str, dist, value):
    """An observation tilde site; falls back to a parameter if missing."""
    return tilde(name, dist, value)


def reject():
    """Early rejection (paper §3.3): zero-probability shortcut."""
    it = current_interpreter()
    it.reject_if(True)


def reject_if(cond):
    """Reject the current run if ``cond``. Eager: aborts; replay: masks
    the accumulator with -inf (no data-dependent branch, vmap-safe)."""
    current_interpreter().reject_if(cond)


def set_logp(value):
    """Overwrite the log-probability accumulator (``@logpdf() = v``)."""
    current_interpreter().set_logp(value)


def get_logp():
    """Read the current accumulator value (``@logpdf()``)."""
    return current_interpreter().logp


def deterministic(name: str, value):
    """Record a derived quantity into the trace (for predictive queries)."""
    current_interpreter().record_deterministic(str(name), value)
    return value


def factor(name: str, logp):
    """Add an arbitrary log-probability term (Turing's ``@addlogprob!``).

    Counts as a LIKELIHOOD contribution: it is scaled by MiniBatchContext
    and dropped under PriorContext. Used e.g. for marginal likelihoods
    computed in-model (HMM forward algorithm)."""
    it = current_interpreter()
    if it.ctx.wants_site(str(name), True):
        it.factor_site(str(name), logp, observed=True)


def prior_factor(name: str, logp):
    """Add a log-probability term that counts as a PRIOR contribution:
    NOT scaled by MiniBatchContext, dropped under LikelihoodContext.

    The minibatch scaling then leaves the prior term unbiased
    (paper §3.1)."""
    it = current_interpreter()
    if it.ctx.wants_site(str(name), False):
        it.factor_site(str(name), logp, observed=False)
