"""Contexts — tailored behaviour during model execution (paper §3.1).

Each model run happens in a specific context:

* ``DefaultContext``    — log joint: priors + likelihood.
* ``LikelihoodContext`` — only observe (tilde-with-data) statements count.
* ``PriorContext``      — only parameter tilde statements count; optionally
  restricted to a subset of variable symbols.
* ``MiniBatchContext``  — wraps another context and scales the LIKELIHOOD
  term by ``scale`` (= N_total / batch_size) so stochastic gradients are
  unbiased (used by SGLD / minibatch VI / large-scale LM training here).

Contexts are static (hashable) objects; they dispatch how the tilde
primitive accumulates log-probability.
"""
from __future__ import annotations

from typing import FrozenSet, Optional

__all__ = [
    "Context", "DefaultContext", "LikelihoodContext", "PriorContext",
    "MiniBatchContext",
]


class Context:
    """Base context. Weights: (prior_weight, likelihood_weight)."""

    def prior_weight(self) -> float:
        return 1.0

    def likelihood_weight(self) -> float:
        return 1.0

    def wants_site(self, sym: str, observed: bool) -> bool:
        """Whether this tilde site contributes to the accumulator at all."""
        return True

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items(), key=lambda kv: kv[0]))))

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class DefaultContext(Context):
    pass


class LikelihoodContext(Context):
    def prior_weight(self) -> float:
        return 0.0

    def wants_site(self, sym: str, observed: bool) -> bool:
        return observed


class PriorContext(Context):
    """Prior log-probability; optionally only for ``vars`` symbols."""

    def __init__(self, vars: Optional[FrozenSet[str]] = None):
        self.vars: Optional[FrozenSet[str]] = frozenset(vars) if vars else None

    def likelihood_weight(self) -> float:
        return 0.0

    def wants_site(self, sym: str, observed: bool) -> bool:
        if observed:
            return False
        return self.vars is None or sym in self.vars

    def __hash__(self):
        return hash(("PriorContext", self.vars))


class MiniBatchContext(Context):
    """Scale likelihood by ``scale`` = N_total / batch (paper §3.1)."""

    def __init__(self, inner: Optional[Context] = None, scale: float = 1.0):
        self.inner = inner if inner is not None else DefaultContext()
        self.scale = float(scale)

    def prior_weight(self) -> float:
        return self.inner.prior_weight()

    def likelihood_weight(self) -> float:
        return self.scale * self.inner.likelihood_weight()

    def wants_site(self, sym: str, observed: bool) -> bool:
        return self.inner.wants_site(sym, observed)

    def __hash__(self):
        return hash(("MiniBatchContext", self.inner, self.scale))
