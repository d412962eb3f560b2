"""Logical-axis sharding rules -> PartitionSpecs, and the inference mesh.

Model code names activation/parameter dimensions with LOGICAL axes
("batch", "embed", "heads", "mlp", "vocab", "experts", "kv_seq", ...).
A rule set maps logical axes to physical mesh axes; a launcher activates
a rule set, and ``constrain``/``spec`` resolve specs against it. With no
active rules everything is a no-op, so the same model code runs on one
device and on a mesh.

``param_spec_for`` maps every parameter leaf of the LM tree to its
tensor-parallel layout by leaf name (wq/wk/wv/wo, gate/up/down, experts,
embed_table, ...), handling the extra leading dim of stacked layers.
With ``fsdp=True`` it additionally shards each large leaf's biggest
still-replicated dim over the data axis (ZeRO-3).

The port's own :class:`PartitionSpec` is a canonical tuple (a one-name
sequence is that name), and a :class:`NamedSharding` gives
``torch.distributed.tensor`` placements, one a mesh axis. ``constrain``
redistributes a ``DTensor`` under active rules with a mesh and returns
anything else as it is.

The inference mesh layer (chains x data on ``torch.distributed``):
:class:`ShardedRun` and :class:`Mesh` (``mesh.py``), the world of one
process a rank (``world.py``), the data-parallel density
(``data_parallel.py``) and the subsampled estimator (``minibatch.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.sharding.data_parallel import (ShardedLogDensity,
                                                make_sharded_logdensity,
                                                shard_slices, sharded_arrays)
from repro_torch.sharding.mesh import Mesh, ShardedRun, active_run, use_run
from repro_torch.sharding.minibatch import (Minibatch, MinibatchLogDensity,
                                            make_minibatch_logdensity)
from repro_torch.sharding.world import init_world, spawn_world

__all__ = ["Rules", "spec", "constrain", "use_rules", "active_rules",
           "DEFAULT_RULES", "LONG_DECODE_RULES", "named_sharding",
           "param_spec_for", "param_shardings", "FSDP_MIN_SIZE",
           "fit_spec", "axes_size", "PartitionSpec", "NamedSharding",
           "placements_for",
           # inference mesh layer (chains x data)
           "Mesh", "ShardedRun", "use_run", "active_run", "init_world",
           "spawn_world", "ShardedLogDensity", "make_sharded_logdensity",
           "shard_slices", "sharded_arrays", "Minibatch",
           "MinibatchLogDensity", "make_minibatch_logdensity"]

AxisVal = Union[None, str, Tuple[str, ...]]


def _canonical(entry) -> AxisVal:
    if entry is None or isinstance(entry, str):
        return entry
    names = tuple(str(a) for a in entry)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim split over their product). Canonical: a
    sequence of one name is that name and an empty one ``None``, so two
    specs of one sharding compare equal."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canonical(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def placements_for(spec: PartitionSpec, axis_names) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` over a mesh with
    ``axis_names``: ``Shard(dim)`` on each axis that splits a dim,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(axis_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: the layout of one tensor."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def placements(self) -> tuple:
        """One placement a mesh axis (see :func:`placements_for`)."""
        return placements_for(self.spec, self.mesh.axis_names)

    def __repr__(self):
        return (f"NamedSharding({self.spec!r}, "
                f"axes={tuple(self.mesh.axis_names)})")


class Rules:
    def __init__(self, mapping: Dict[str, AxisVal], mesh=None,
                 fsdp: bool = False):
        self.mapping = dict(mapping)
        self.mesh = mesh
        self.fsdp = fsdp

    def with_mesh(self, mesh) -> "Rules":
        # drop rules that reference axes the mesh does not have
        valid = set(mesh.axis_names)

        def ok(v: AxisVal) -> AxisVal:
            if v is None:
                return None
            if isinstance(v, str):
                return v if v in valid else None
            kept = tuple(a for a in v if a in valid)
            if not kept:
                return None
            # a 1-tuple is the bare axis name: the same sharding, one form
            return kept[0] if len(kept) == 1 else kept

        return Rules({k: ok(v) for k, v in self.mapping.items()}, mesh,
                     self.fsdp)

    def with_fsdp(self, on: bool = True) -> "Rules":
        return Rules(self.mapping, self.mesh, on)

    def replace(self, **updates) -> "Rules":
        return Rules(dict(self.mapping, **updates), self.mesh, self.fsdp)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        out = []
        for name in logical:
            out.append(None if name is None else self.mapping.get(name))
        return PartitionSpec(*out)


# batch over (pod, data); tensor-parallel over model; experts over model (EP)
DEFAULT_RULES = Rules({
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "q_lora": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "conv": None,
    "state": None,
    "data_axes": ("pod", "data"),  # FSDP target axes (params/opt states)
})

# long-context single-sequence decode: batch=1, shard the KV length instead
LONG_DECODE_RULES = DEFAULT_RULES.replace(batch=None, kv_seq=("pod", "data"))

_tls = threading.local()


def active_rules() -> Optional[Rules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def spec(*logical: Optional[str]) -> PartitionSpec:
    r = active_rules()
    if r is None:
        return PartitionSpec()
    return r.spec(*logical)


def constrain(x, *logical: Optional[str]):
    """Lay ``x`` out as the active rules say (a no-op with none). Only a
    ``DTensor`` carries a layout: it is redistributed over its own device
    mesh; anything else is returned as it is. Axes that do not divide the
    dim are dropped (see ``fit_spec``)."""
    r = active_rules()
    if r is None or r.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    s = fit_spec(r.spec(*logical), tuple(x.shape), r.mesh)
    return x.redistribute(x.device_mesh, placements_for(
        s, x.device_mesh.mesh_dim_names))


def named_sharding(mesh, *logical: Optional[str],
                   rules: Optional[Rules] = None) -> NamedSharding:
    r = (rules or active_rules() or DEFAULT_RULES).with_mesh(mesh)
    return NamedSharding(mesh, r.spec(*logical))


# ---------------------------------------------------------------------------
# parameter layouts
# ---------------------------------------------------------------------------
# base logical spec per leaf name, WITHOUT the stacked-layers leading dim.
# (the trailing entries align to the leaf's trailing dims)
_LEAF_SPECS: Dict[str, Tuple[Optional[str], ...]] = {
    # attention (GQA / cross)
    "wq": (None, "heads", None),
    "wk": (None, "kv_heads", None),
    "wv": (None, "kv_heads", None),
    "wo": ("heads", None, None),
    # MLA
    "w_dkv": (None, None),
    "w_krope": (None, None),
    "w_uk": (None, "heads", None),
    "w_uv": (None, "heads", None),
    # MLP (gated + relu2)
    "w_gate": (None, "mlp"),
    "w_up": (None, "mlp"),
    "w_down": ("mlp", None),
    # router replicated (tiny, latency-critical)
    "router": (None, None),
    # mamba2
    "in_proj": (None, "mlp"),
    "out_proj": ("mlp", None),
    "conv_w": (None, "mlp"),
    # rg-lru
    "in_x": (None, "mlp"),
    "in_gate": (None, "mlp"),
    "w_a": ("mlp", None),
    "w_x": ("mlp", None),
    "out": ("mlp", None),
    # embeddings / projections
    "embed_table": ("vocab", None),
    "prefix_proj": (None, "mlp"),
}

# experts leaves carry a leading (n_experts,) dim on top of the MLP spec
_EXPERT_SPECS: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("experts", None, "expert_mlp"),
    "w_up": ("experts", None, "expert_mlp"),
    "w_down": ("experts", "expert_mlp", None),
}

FSDP_MIN_SIZE = 2 ** 18  # leaves below 256Ki elements stay replicated


def _leaf_name(path: Tuple) -> Tuple[str, bool]:
    """(final dict key, inside-experts?) from a tree path: its entries are
    ``torch.utils._pytree`` keys (or anything with ``.key``) or strings;
    list indices carry no key."""
    keys = [k if isinstance(k, str) else k.key for k in path
            if isinstance(k, str) or hasattr(k, "key")]
    name = keys[-1] if keys else ""
    return name, "experts" in keys


def axes_size(mesh, axisval: AxisVal) -> int:
    if axisval is None or mesh is None:
        return 1
    names = (axisval,) if isinstance(axisval, str) else axisval
    n = 1
    for a in names:
        n *= dict(zip(mesh.axis_names, mesh.devices.shape))[a]
    return n


def fit_spec(spec: PartitionSpec, shape: Tuple[int, ...],
             mesh) -> PartitionSpec:
    """Drop spec entries whose mesh-axis product does not divide the dim —
    a sharded dim must split evenly (replicate instead). Non-divisible
    cases in the assigned archs: smollm 15H/5KV vs model=16, GQA kv=8 <
    model=16, odd vocab sizes (49155, 92553, 256206, 50280)."""
    if mesh is None:
        return PartitionSpec(*spec)
    out = []
    for i, entry in enumerate(tuple(spec)):
        n = axes_size(mesh, entry)
        out.append(entry if (n > 1 and shape[i] % n == 0) or n == 1
                   else None)
    return PartitionSpec(*out)


def param_spec_for(path, shape: Tuple[int, ...], rules: Rules
                   ) -> PartitionSpec:
    """Logical layout for one parameter leaf (see module docstring)."""
    name, in_experts = _leaf_name(tuple(path))
    ndim = len(shape)
    base = _EXPERT_SPECS.get(name) if in_experts else _LEAF_SPECS.get(name)
    if base is None or ndim < len(base):
        logical = [None] * ndim          # norms, biases, scalars: replicate
    else:
        # stacked params carry extra LEADING dims (segment stacking)
        logical = [None] * (ndim - len(base)) + list(base)

    base_spec = fit_spec(rules.spec(*logical), shape, rules.mesh)
    if rules.fsdp and int(np.prod(shape)) >= FSDP_MIN_SIZE:
        data_axes = rules.mapping.get("data_axes") or "data"
        n_data = axes_size(rules.mesh, data_axes)
        # shard the largest still-unsharded DIVISIBLE dim over data (ZeRO-3)
        order = sorted(range(ndim), key=lambda i: -shape[i])
        for i in order:
            if (base_spec[i] is None and shape[i] > 1
                    and shape[i] % max(n_data, 1) == 0):
                return PartitionSpec(*[
                    data_axes if j == i else base_spec[j]
                    for j in range(ndim)])
    return base_spec


def param_shardings(mesh, shapes_tree, rules: Rules):
    """:class:`NamedSharding` tree for a parameter (or optimizer-state)
    tree of tensors or shape-carrying leaves (``torch.utils._pytree``'s
    containers); leaves without a shape (scalars) are replicated."""
    from torch.utils._pytree import tree_map_with_path

    r = rules.with_mesh(mesh)

    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        return NamedSharding(mesh, param_spec_for(path, shape, r))

    return tree_map_with_path(one, shapes_tree)
