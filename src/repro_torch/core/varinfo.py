"""VarInfo — the paper's central data structure (§2.2), on PyTorch tensors.

``UntypedVarInfo`` is the dynamic discovery structure: a plain dict trace
built while the model runs eagerly.

``TypedVarInfo`` is the concretely-typed trace: per-site tensors with fixed
shapes/dtypes, stored distributions, and static metadata. ``typify``
performs the paper's "type inference for traces": element sites written in
loops (``x[0]``, ``x[1]``, …) are grouped into one stacked array, exactly
like DynamicPPL's grouped metadata ranges.

``link``/``invlink`` move values between the constrained support and the
unconstrained reals (Stan-style) using the per-site stored distribution.

The typed trace carries a ``FlatLayout``: static per-site slice/shape
metadata, computed once per trace type, describing where every site lives
inside ONE flat buffer (both the constrained and the unconstrained layout).
``flat``/``replace_flat`` are driven entirely by this layout, so the
whole-trace <-> R^n conversion that every leapfrog step performs is a fixed
sequence of slices. ``replace_flat`` slices the LAST axis only through
logical indexing, so it runs unchanged under ``torch.func.vmap`` over a
leading chain axis.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.bijectors import bijector_for
from repro_torch.core.varname import VarName

__all__ = ["UntypedVarInfo", "TypedVarInfo", "typify", "SiteMeta",
           "SiteSlice", "FlatLayout", "layout_for",
           "assert_continuous_supports"]

_DISCRETE_SUPPORTS = ("discrete", "nonnegative_int", "binary")


def assert_continuous_supports(tvi: "TypedVarInfo", algorithm: str) -> None:
    """Fail fast when a gradient-based algorithm meets discrete sites.

    Raises a ``ValueError`` naming every discrete parameter site and the
    algorithm, with the marginalisation remedy.
    """
    bad = [(m.name, m.support) for m in tvi.metas
           if m.support in _DISCRETE_SUPPORTS]
    if bad:
        sites = ", ".join(f"'{n}' ({s})" for n, s in bad)
        raise ValueError(
            f"{algorithm} requires continuous parameter sites, but the "
            f"model has discrete parameter site(s) {sites}. Gradient-based "
            "inference cannot move discrete coordinates — marginalise them "
            "out inside the model (sum over the categories) or sample them "
            "with a non-gradient kernel (e.g. MH)."
        )


# ---------------------------------------------------------------------------
# Untyped trace
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Record:
    value: Any
    dist: Any
    order: int


class UntypedVarInfo:
    """Dynamic, mutable, anything-goes trace (paper's UntypedVarInfo)."""

    def __init__(self):
        self._records: Dict[str, _Record] = {}

    def __contains__(self, name: str) -> bool:
        return str(name) in self._records

    def __getitem__(self, name: str):
        return self._records[str(name)].value

    def set(self, name: str, value, dist) -> None:
        key = str(name)
        if key in self._records:
            rec = self._records[key]
            rec.value, rec.dist = value, dist
        else:
            self._records[key] = _Record(value, dist, len(self._records))

    def dist_of(self, name: str):
        return self._records[str(name)].dist

    def names(self) -> List[str]:
        return sorted(self._records, key=lambda n: self._records[n].order)

    def as_dict(self) -> Dict[str, Any]:
        return {n: self._records[n].value for n in self.names()}

    def __repr__(self):
        inner = ", ".join(
            f"{n}: {tuple(torch.as_tensor(self._records[n].value).shape)}"
            for n in self.names())
        return f"UntypedVarInfo({inner})"


# ---------------------------------------------------------------------------
# Typed trace
# ---------------------------------------------------------------------------
class SiteMeta(NamedTuple):
    name: str            # symbol ("w"); grouped element sites share one sym
    shape: Tuple[int, ...]
    dtype: str
    support: str
    grouped: bool        # stacked from element sites x[0], x[1], ...
    nelems: int          # number of element sites (1 if not grouped)
    unc_shape: Tuple[int, ...]  # unconstrained shape (per link())


def _meta_for(sym: str, value: torch.Tensor, dist, grouped: bool,
              nelems: int) -> SiteMeta:
    shape = tuple(value.shape)
    dtype = str(value.dtype).replace("torch.", "")
    support = getattr(dist, "support", "real")
    if support in _DISCRETE_SUPPORTS:
        unc_shape = shape
    else:
        unc_shape = tuple(bijector_for(dist).unconstrained_shape(shape))
    return SiteMeta(sym, shape, dtype, support, grouped, nelems, unc_shape)


class SiteSlice(NamedTuple):
    """Static flat-buffer coordinates of one site (see ``FlatLayout``).

    ``offset``/``size``/``shape`` address the CONSTRAINED flat buffer,
    ``unc_offset``/``unc_size``/``unc_shape`` the UNCONSTRAINED one (e.g. a
    K-simplex occupies K-1 slots); ``dtype`` is the stored value's dtype
    name and ``support`` the distribution's support tag.
    """

    name: str
    offset: int
    size: int
    shape: Tuple[int, ...]
    unc_offset: int
    unc_size: int
    unc_shape: Tuple[int, ...]
    dtype: str
    support: str


class FlatLayout(NamedTuple):
    """Whole-trace flat-buffer layout: one ``SiteSlice`` per site."""

    sites: Tuple[SiteSlice, ...]
    size: int
    unc_size: int

    def slice_of(self, sym: str) -> SiteSlice:
        for s in self.sites:
            if s.name == sym:
                return s
        raise KeyError(f"no site '{sym}' in layout")


@functools.lru_cache(maxsize=None)
def layout_for(metas: Tuple[SiteMeta, ...]) -> FlatLayout:
    """Compute the ``FlatLayout`` for a tuple of site metadata.

    Cached on the (hashable) metadata tuple: every ``TypedVarInfo`` sharing
    one trace type shares one layout object.
    """
    sites, off, unc_off = [], 0, 0
    for m in metas:
        n = int(np.prod(m.shape)) if m.shape else 1
        un = int(np.prod(m.unc_shape)) if m.unc_shape else 1
        sites.append(SiteSlice(m.name, off, n, m.shape, unc_off, un,
                               m.unc_shape, m.dtype, m.support))
        off += n
        unc_off += un
    return FlatLayout(tuple(sites), off, unc_off)


class TypedVarInfo:
    """Concretely-typed trace: per-site tensors + distributions.

    ``linked=False``: values live on the constrained support.
    ``linked=True``: values are unconstrained reals (HMC space).
    """

    def __init__(self, values: Tuple, dists: Tuple, metas: Tuple[SiteMeta, ...],
                 linked: bool = False):
        self.values = tuple(values)
        self.dists = tuple(dists)
        self.metas = tuple(metas)
        self.linked = bool(linked)
        self.layout = layout_for(self.metas)
        self._index = {m.name: i for i, m in enumerate(self.metas)}

    # -- lookups -------------------------------------------------------------
    def site_index(self, sym: str) -> int:
        return self._index[sym]

    def __contains__(self, name) -> bool:
        vn = name if isinstance(name, VarName) else VarName.parse(str(name))
        return vn.sym in self._index

    def raw_value(self, sym: str):
        """The stored value of a site: unconstrained when linked."""
        return self.values[self._index[sym]]

    def dist_of(self, sym: str):
        return self.dists[self._index[sym]]

    @property
    def device(self) -> torch.device:
        return self.values[0].device if self.values else torch.device("cpu")

    def constrained_values(self) -> Tuple:
        if not self.linked:
            return self.values
        out = []
        for v, d, m in zip(self.values, self.dists, self.metas):
            if m.support in _DISCRETE_SUPPORTS:
                out.append(v)
            else:
                out.append(bijector_for(d).forward(v))
        return tuple(out)

    def __getitem__(self, name):
        """Constrained value of a site (or element of a grouped site)."""
        vn = name if isinstance(name, VarName) else VarName.parse(str(name))
        i = self._index[vn.sym]
        v = self.constrained_values()[i]
        if vn.indexed and self.metas[i].grouped:
            idx = vn.index if len(vn.index) > 1 else vn.index[0]
            return v[idx]
        return v

    def as_dict(self) -> Dict[str, Any]:
        return {m.name: v for m, v in zip(self.metas, self.constrained_values())}

    # -- link / invlink --------------------------------------------------------
    def link(self) -> "TypedVarInfo":
        if self.linked:
            return self
        out = []
        for v, d, m in zip(self.values, self.dists, self.metas):
            if m.support in _DISCRETE_SUPPORTS:
                raise ValueError(
                    f"site '{m.name}' is discrete ({m.support}); cannot link "
                    "for gradient-based inference — marginalise it instead."
                )
            out.append(bijector_for(d).inverse(v))
        return TypedVarInfo(tuple(out), self.dists, self.metas, linked=True)

    def invlink(self) -> "TypedVarInfo":
        if not self.linked:
            return self
        return TypedVarInfo(self.constrained_values(), self.dists, self.metas,
                            linked=False)

    # -- flat vector interface (HMC / optimisers) -----------------------------
    @property
    def num_flat(self) -> int:
        """Length of ``flat()``: ``layout.unc_size`` when linked else
        ``layout.size``."""
        return self.layout.unc_size if self.linked else self.layout.size

    def flat(self) -> torch.Tensor:
        """Pack the trace into one flat float32 vector ``(num_flat,)``.

        Site blocks are concatenated in layout order, each reshaped through
        its ``unc_shape`` when linked and its ``shape`` otherwise — exactly
        the layout :meth:`replace_flat` unpacks. A value whose size
        disagrees with the layout raises here.
        """
        parts = []
        for v, s in zip(self.values, self.layout.sites):
            shape = s.unc_shape if self.linked else s.shape
            parts.append(torch.reshape(torch.as_tensor(v), shape).reshape(-1)
                         .to(torch.float32))
        if not parts:
            return torch.zeros((0,))
        return torch.cat(parts)

    def replace_flat(self, vec: torch.Tensor) -> "TypedVarInfo":
        """Unpack a flat vector ``(num_flat,)`` into a new trace (inverse of
        :meth:`flat`). Unlinked traces cast each block back to the site's
        concrete dtype."""
        out = []
        for s in self.layout.sites:
            if self.linked:
                off, n, shape = s.unc_offset, s.unc_size, s.unc_shape
                out.append(vec[off:off + n].reshape(shape))
            else:
                off, n, shape = s.offset, s.size, s.shape
                out.append(vec[off:off + n].reshape(shape)
                           .to(getattr(torch, s.dtype)))
        return TypedVarInfo(tuple(out), self.dists, self.metas, self.linked)

    def replace_values(self, values: Tuple) -> "TypedVarInfo":
        """The same trace type with every site's stored value replaced."""
        return TypedVarInfo(tuple(values), self.dists, self.metas, self.linked)

    def replace_site(self, sym: str, value) -> "TypedVarInfo":
        """The same trace with one site's stored value replaced."""
        i = self._index[sym]
        vals = list(self.values)
        vals[i] = value
        return TypedVarInfo(tuple(vals), self.dists, self.metas, self.linked)

    def __repr__(self):
        inner = ", ".join(f"{m.name}:{m.shape}{'~' + m.support}" for m in self.metas)
        return f"TypedVarInfo({'linked; ' if self.linked else ''}{inner})"


# ---------------------------------------------------------------------------
# typify — the paper's trace type inference
# ---------------------------------------------------------------------------
def _try_stack_dists(dists: List[Any]):
    """Stack per-element dist params into one batched dist if homogeneous."""
    first = dists[0]
    if not all(type(d) is type(first) for d in dists):
        return first
    try:
        fields = {f.name: torch.stack([torch.as_tensor(getattr(d, f.name))
                                       for d in dists])
                  for f in dataclasses.fields(first)}
    except (TypeError, RuntimeError):
        return first
    return type(first)(**fields)


def typify(uvi: UntypedVarInfo) -> TypedVarInfo:
    """UntypedVarInfo -> TypedVarInfo (shape/dtype/support inference).

    Element sites ``x[i]`` of one symbol are grouped into a stacked array
    (DynamicPPL's metadata ranges); scalar/whole-array sites pass through.
    """
    groups: Dict[str, List[Tuple[VarName, Any, Any]]] = {}
    order: List[str] = []
    for name in uvi.names():
        vn = VarName.parse(name)
        if vn.sym not in groups:
            groups[vn.sym] = []
            order.append(vn.sym)
        groups[vn.sym].append((vn, uvi[name], uvi.dist_of(name)))

    values, dists, metas = [], [], []
    for sym in order:
        sites = groups[sym]
        if len(sites) == 1 and not sites[0][0].indexed:
            vn, val, dist = sites[0]
            val = torch.as_tensor(val)
            values.append(val)
            dists.append(dist)
            metas.append(_meta_for(sym, val, dist, grouped=False, nelems=1))
        else:
            sites = sorted(sites, key=lambda s: s[0].index)
            stacked = torch.stack([torch.as_tensor(v) for _, v, _ in sites])
            dist = _try_stack_dists([d for _, _, d in sites])
            values.append(stacked)
            dists.append(dist)
            metas.append(_meta_for(sym, stacked, dist, grouped=True,
                                   nelems=len(sites)))
    return TypedVarInfo(tuple(values), tuple(dists), tuple(metas), linked=False)
