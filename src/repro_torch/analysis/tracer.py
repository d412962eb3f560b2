"""Dataflow tracer: which parameter symbols each tensor depends on.

``repro`` recovers a model's parameter-level dataflow from
``jax.make_jaxpr``: every parameter site's value is a function input and a
forward pass over the equations unions each equation's input dependencies
into its outputs. ``torch.fx`` cannot follow the DSL's Python (its
interpreter stack, dataclass distributions, loops over sites), so the port
runs the model eagerly under :class:`DependencyTracer`, a
``TorchFunctionMode`` that keeps a weak map from tensors to the frozenset
of parameter symbols they depend on:

* :meth:`DependencyTracer.tag` gives a parameter site's stored value its
  own symbol;
* every torch function or tensor method the replay calls gives its tensor
  outputs the union of its tensor inputs' sets (the counterpart of
  ``repro.analysis.graph._propagate_deps``, and sound in the same way: an
  output may be tagged with a symbol it does not really depend on, never
  the other way round). An in-place op (a method ending in ``_``,
  ``__setitem__``, ``__iadd__`` and the like, an ``out=`` tensor) also adds
  that union to the tensor it writes; a view reads its base's set and a
  write through a view reaches its base. Ops whose result does not depend
  on their inputs' values (``zeros_like``, ``new_ones``, ...) pass no
  dependency on, as their ``jaxpr`` does not;
* reading a tagged tensor on the host (``bool``, ``int``, ``float``,
  ``operator.index``, ``item``, ``tolist``, ``numpy``, ``__array__``) and
  an op whose output SHAPE depends on a tagged tensor's values
  (``nonzero``, boolean-mask indexing, ``masked_select``, ``unique``,
  ``bincount``, ``repeat_interleave`` by tagged counts, one-argument
  ``where``) raise :class:`ConcretizationError`, the port's
  ``jax.errors.ConcretizationTypeError``: the model's structure would
  depend on a random variable.

The tracer sees tensors, not Python numbers, so a value that leaves torch
without a host read (it cannot) carries no dependency. Untagged tensors
(the model's data) are read freely.
"""
from __future__ import annotations

from typing import FrozenSet

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakTensorKeyDictionary

__all__ = ["ConcretizationError", "DependencyTracer"]

_EMPTY: FrozenSet[str] = frozenset()

# tensor methods that hand a value to the host
_HOST_READS = frozenset(["__bool__", "__int__", "__float__", "__index__",
                         "__complex__", "item", "tolist", "numpy",
                         "__array__"])
# ops whose output shape depends on their (first) input's values
_DATA_SHAPED = frozenset(["nonzero", "argwhere", "masked_select", "unique",
                          "unique_consecutive", "bincount"])
# ops whose output depends on the input's shape, dtype and device only
_VALUE_FREE = frozenset(["zeros_like", "ones_like", "empty_like",
                         "full_like", "rand_like", "randn_like",
                         "randint_like", "new_zeros", "new_ones",
                         "new_empty", "new_full", "new_tensor"])
_INPLACE_DUNDERS = frozenset([
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__",
    "__ifloordiv__", "__imod__", "__ipow__", "__iand__", "__ior__",
    "__ixor__", "__ilshift__", "__irshift__", "__imatmul__"])


class ConcretizationError(RuntimeError):
    """A traced tensor's value was needed on the host (Python control flow
    or a data-dependent shape on a random variable)."""


def _tensors(x, out):
    """Append every tensor in the nested args ``x`` to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _name(func) -> str:
    return getattr(func, "__name__", "") or ""


class DependencyTracer(TorchFunctionMode):
    """Propagate parameter-symbol sets through every torch op run inside
    the ``with`` block; see the module docstring."""

    def __init__(self):
        super().__init__()
        self._deps = WeakTensorKeyDictionary()

    # -- the map -----------------------------------------------------------
    def tag(self, t: torch.Tensor, sym: str) -> torch.Tensor:
        """Mark ``t`` as the value of parameter ``sym``."""
        self._deps[t] = self.deps(t) | frozenset([sym])
        return t

    def deps(self, x) -> FrozenSet[str]:
        """Symbols the tensor (or nested tensors) ``x`` depends on."""
        out = _EMPTY
        for t in _tensors(x, []):
            d = self._deps.get(t)
            if d:
                out = out | d
            base = t._base
            if base is not None:
                d = self._deps.get(base)
                if d:
                    out = out | d
        return out

    def _add(self, t: torch.Tensor, d: FrozenSet[str]) -> None:
        self._deps[t] = self._deps.get(t, _EMPTY) | d
        if t._base is not None:
            self._deps[t._base] = self._deps.get(t._base, _EMPTY) | d

    # -- the mode ----------------------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in _VALUE_FREE:
            return func(*args, **kwargs)
        d = self.deps((args, kwargs))
        if d:
            self._refuse_reads(name, args, kwargs, d)
        out = func(*args, **kwargs)
        if not d:
            return out
        if name in _INPLACE_DUNDERS or (name.endswith("_")
                                        and not name.startswith("__")):
            if args and isinstance(args[0], torch.Tensor):
                self._add(args[0], d)
        for t in _tensors(kwargs.get("out"), []):
            self._add(t, d)
        for t in _tensors(out, []):
            self._add(t, d)
        return out

    def _refuse_reads(self, name, args, kwargs, d) -> None:
        what = None
        if name in _HOST_READS:
            what = f"Tensor.{name}"
        elif name in _DATA_SHAPED:
            what = name
        elif name == "where" and len(args) + len(kwargs) == 1:
            what = "where(condition)"
        elif name == "repeat_interleave" and self.deps(
                (args[1:], kwargs.get("repeats"))):
            what = "repeat_interleave by traced counts"
        elif name == "__getitem__" and len(args) > 1:
            for t in _tensors(args[1], []):
                if t.dtype == torch.bool and self.deps(t):
                    what = "boolean-mask indexing"
                    break
        if what is not None:
            raise ConcretizationError(
                f"{what} of a traced tensor that depends on "
                f"{sorted(d)}: its value is needed on the host")
