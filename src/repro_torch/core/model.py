"""@model decorator, ModelGen and Model (paper §2.1).

``@model`` turns a Python generative function into a ``ModelGen`` (the
paper's model-constructor type). Calling the generator with data binds the
arguments and yields a ``Model``. Arguments bound to ``missing``/``None``
become model parameters at their tilde sites (automatic parameter/data
determination).

Model evaluation methods mirror the paper's phases:

* ``untyped_trace``  — eager discovery run filling an UntypedVarInfo.
* ``typed_varinfo``  — discovery + ``typify``: the typed trace that every
                        density evaluation specialises on.
* ``logjoint / logprior / loglikelihood / logp_with_context`` —
                        context-dispatched densities.
* ``make_logdensity_fn`` — flat unconstrained R^n -> log density (HMC).

The samplers reach ``make_logdensity_fn`` through the program cache
(``core/program.py``), keyed on the generator's uid and the bound data.
"""
from __future__ import annotations

import functools
import inspect
import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.contexts import (Context, DefaultContext,
                                       LikelihoodContext, PriorContext)
from repro_torch.core.interpreters import (EarlyRejectError, Evaluator,
                                           FusedEvaluator,
                                           FusedLinkedEvaluator,
                                           LinkedEvaluator, Sampler,
                                           pop_interpreter, push_interpreter)
from repro_torch.core.primitives import missing
from repro_torch.core.varinfo import TypedVarInfo, UntypedVarInfo, typify

__all__ = ["model", "Model", "ModelGen"]

_UIDS = itertools.count()


class ModelGen:
    """The model constructor produced by ``@model`` (paper's ModelGen)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__
        self.signature = inspect.signature(fn)
        self.arg_names = tuple(self.signature.parameters)
        # process-monotonic identity for program-cache keys (never reused,
        # unlike id())
        self._uid = next(_UIDS)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs) -> "Model":
        bound = self.signature.bind_partial(*args, **kwargs)
        # unbound args default to `missing` => parameters
        data = {}
        for name in self.arg_names:
            if name in bound.arguments:
                data[name] = bound.arguments[name]
            else:
                default = self.signature.parameters[name].default
                data[name] = missing if default is inspect.Parameter.empty else default
        return Model(self, data)

    def __repr__(self):
        return f"ModelGen({self.name})"


def model(fn: Callable) -> ModelGen:
    return ModelGen(fn)


class Model:
    """A ModelGen bound to data. Immutable; evaluation methods below."""

    def __init__(self, gen: ModelGen, data: Dict[str, Any]):
        self.gen = gen
        self.data = dict(data)

    @property
    def name(self) -> str:
        return self.gen.name

    def bind(self, **updates) -> "Model":
        """A new ``Model`` of the same model function, with ``updates``
        replacing the bound data of those names."""
        new = dict(self.data)
        new.update(updates)
        return Model(self.gen, new)

    # -- raw execution under an interpreter ------------------------------------
    def _run(self, interpreter) -> Tuple[Any, Any]:
        push_interpreter(interpreter)
        try:
            retval = self.gen.fn(**self.data)
        except EarlyRejectError:
            interpreter.set_logp(-torch.inf)
            retval = None
        finally:
            pop_interpreter()
        return retval, interpreter

    # -- phase 1: untyped discovery ------------------------------------------
    def untyped_trace(self, generator: torch.Generator,
                      ctx: Optional[Context] = None,
                      init_strategy: str = "prior",
                      base_vi: Optional[UntypedVarInfo] = None) -> UntypedVarInfo:
        """Run the model once eagerly, drawing parameters from
        ``generator`` (on the device the model's data live on)."""
        it = Sampler(generator, vi=base_vi, ctx=ctx,
                     init_strategy=init_strategy)
        self._run(it)
        return it.vi

    # -- phase 2: typed trace ---------------------------------------------------
    def typed_varinfo(self, generator: torch.Generator,
                      init_strategy: str = "prior") -> TypedVarInfo:
        return typify(self.untyped_trace(generator,
                                         init_strategy=init_strategy))

    # -- densities ----------------------------------------------------------------
    def _eval_logp(self, values, ctx: Context, eager: bool = False,
                   backend: str = "fused") -> torch.Tensor:
        if backend not in ("fused", "reference"):
            raise ValueError(f"unknown density backend '{backend}'; "
                             "expected 'fused' or 'reference'")
        fused = backend == "fused" and not eager
        if isinstance(values, TypedVarInfo) and values.linked:
            cls = FusedLinkedEvaluator if fused else LinkedEvaluator
        else:
            cls = FusedEvaluator if fused else Evaluator
        it = cls(values, ctx=ctx, eager=eager)
        _, it = self._run(it)
        return it.logp

    def logjoint(self, values, backend: str = "fused") -> torch.Tensor:
        """Log joint density of ``values`` under this model.

        ``backend="fused"`` (default) gathers same-family tilde sites into
        flat blocks and evaluates each with one ``fused_logpdf`` launch;
        ``backend="reference"`` evaluates per site (the oracle path the
        parity tests compare against).
        """
        return self._eval_logp(values, DefaultContext(), backend=backend)

    def logprior(self, values, vars=None, backend: str = "fused") -> torch.Tensor:
        return self._eval_logp(values, PriorContext(vars), backend=backend)

    def loglikelihood(self, values, backend: str = "fused") -> torch.Tensor:
        return self._eval_logp(values, LikelihoodContext(), backend=backend)

    def logp_with_context(self, values, ctx: Context,
                          backend: str = "fused") -> torch.Tensor:
        """The density of ``values`` under any context (a
        ``MiniBatchContext``'s likelihood scaling, say)."""
        return self._eval_logp(values, ctx, backend=backend)

    # -- eager (UNTYPED) density: the paper's slow general path ---------------
    def logjoint_untyped(self, values_dict: Dict[str, Any]) -> float:
        """Eager evaluation op by op, the UntypedVarInfo execution mode:
        dispatches on whatever the dict holds, ``reject()`` short-circuits
        the run, and the result is a Python float."""
        it = Evaluator(values_dict, ctx=DefaultContext(), eager=True)
        _, it = self._run(it)
        return float(torch.as_tensor(it.logp))

    # -- flat log-density for gradient-based inference -----------------------
    def make_logdensity_fn(self, tvi_linked: TypedVarInfo,
                           ctx: Optional[Context] = None,
                           backend: str = "fused") -> Callable:
        """Build the flat unconstrained log-density ``R^num_flat -> R``.

        Parameters
        ----------
        tvi_linked : TypedVarInfo
            Linked typed trace whose ``FlatLayout`` fixes the buffer layout
            the returned function is specialised on.
        ctx : Context, optional
            Accumulation context (default joint).
        backend : {"fused", "reference"}
            ``"fused"`` evaluates same-family site blocks through
            ``kernels.fused_logpdf`` in one launch per family — the hot
            path the samplers run. ``"reference"`` keeps the per-site
            evaluation (oracle path).

        Returns
        -------
        callable
            ``flat_u -> log p(forward(flat_u)) + log|det J|`` for one
            ``(num_flat,)`` vector; compose with ``torch.func.grad`` and
            ``torch.func.vmap`` for gradients over a chain axis.
        """
        if not tvi_linked.linked:
            raise ValueError("make_logdensity_fn needs a linked TypedVarInfo")
        if backend not in ("fused", "reference"):
            raise ValueError(f"unknown density backend '{backend}'; "
                             "expected 'fused' or 'reference'")
        ctx = ctx if ctx is not None else DefaultContext()

        def logdensity(flat_u):
            tvi = tvi_linked.replace_flat(flat_u)
            return self._eval_logp(tvi, ctx, backend=backend)

        return logdensity

    # -- predictive / posterior draws -----------------------------------------
    def sample_prior(self, seed_or_generator) -> Dict[str, Any]:
        """One draw of every parameter site from the prior, by site name.
        Takes a ``torch.Generator`` or an integer seed where the JAX package
        takes a key; a seed draws on the device of the model's tensor data
        (the CPU when it has none)."""
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            dev = next((v.device for v in self.data.values()
                        if torch.is_tensor(v)), torch.device("cpu"))
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        return self.untyped_trace(gen).as_dict()

    def __repr__(self):
        bound = {k: ("missing" if v is missing or v is None else "<data>")
                 for k, v in self.data.items()}
        return f"Model({self.name}, {bound})"
