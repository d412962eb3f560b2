"""ShardedRun — the chains × data placement plan for inference, on
``torch.distributed``.

A :class:`ShardedRun` fixes, once a run, how a chain fleet and its
observed data are laid over a :class:`Mesh` of ranks, as ``repro``'s
over a ``jax.sharding.Mesh``:

* the ``chains`` mesh axis partitions the fleet's leading chain axis, so a
  fleet of N chains runs as ``num_chain_devices`` blocks of
  ``N / num_chain_devices`` chains, one a rank;
* the ``data`` mesh axis partitions the leading (observation) axis of the
  ``shard_sites`` data arrays, so each rank evaluates the likelihood of
  its shard and one all-reduce joins them
  (:mod:`repro_torch.sharding.data_parallel`).

Where ``repro`` drives the mesh from one controller (``shard_map`` over
``jax.devices()``), the port runs one process a rank
(:mod:`repro_torch.sharding.world`), and every rank calls ``run_chains``
with the same arguments. The plan is value-complete: what a program
depends on (mesh shape, axis names, sharded sites) is in
:meth:`ShardedRun.fingerprint`, which ``ProgramKey.sharding`` stores.
With one device the plan is :attr:`ShardedRun.is_trivial` and every
consumer keeps the single-device path.

:func:`use_run` makes a plan the active one for a block, as
``sharding.use_rules`` does rules: the chain drivers set it around a mesh
run, and what runs inside reads it (:func:`active_run`) to find this
rank's rows of the fleet's draws and the process group of a mesh axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["Mesh", "ShardedRun", "active_run", "use_run"]


def _dist():
    import torch.distributed as dist
    return dist


def world_rank() -> int:
    """This process's rank in the torch.distributed world (0 without one)."""
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


# sorted ranks -> this process's group over them, for the current world
_GROUPS: Dict[Tuple, object] = {}


def _group_of(ranks: Sequence[int]):
    """The process group over ``ranks`` (this rank among them), made once
    a world. Only its members make it (local synchronisation), so a mesh
    over part of the world needs nothing of the other ranks."""
    dist = _dist()
    key = (id(dist.group.WORLD), tuple(sorted(int(r) for r in ranks)))
    group = _GROUPS.get(key)
    if group is None:
        if len(set(key[1])) != len(key[1]):
            raise ValueError(f"mesh ranks {list(ranks)} repeat a rank; a "
                             "mesh that runs lays distinct ranks out")
        group = _GROUPS[key] = dist.new_group(
            list(key[1]), use_local_synchronization=True)
    return group


class Mesh:
    """A grid of ranks with named axes.

    It holds what the port's sharding reads of a ``jax.sharding.Mesh``:
    ``axis_names`` and ``devices`` (here the ranks, an integer array whose
    ``shape`` is the mesh's), so a ``Mesh``-shaped stand-in drives the
    pure spec logic of both packages alike. When a world exists, the
    process group of each axis through the calling rank (and of the whole
    mesh) is made at the first :meth:`group` call, once.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices)
        names = tuple(str(a) for a in axis_names)
        if grid.ndim != len(names):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} axis names, got {names}")
        self.devices = grid
        self.axis_names = names
        self._groups = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The position of ``rank`` (default: this process's) in the grid."""
        rank = world_rank() if rank is None else int(rank)
        hits = np.argwhere(self.devices == rank)
        if not len(hits):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return tuple(int(i) for i in hits[0])

    def axis_ranks(self, axis, rank: Optional[int] = None
                   ) -> Tuple[int, ...]:
        """The ranks along ``axis`` through ``rank``, in axis order: one
        axis name, or a tuple of names for the sub-grid they span, numbered
        as ``jax.lax.axis_index`` numbers it (the first name's axis the
        slowest); every rank of the mesh for ``axis=None``."""
        if axis is None:
            return tuple(int(r) for r in self.devices.reshape(-1))
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        pos = self.coords(rank)
        rest = [i for i, n in enumerate(self.axis_names) if n not in names]
        grid = np.transpose(self.devices, rest + [
            self.axis_names.index(n) for n in names])
        return tuple(int(r) for r in
                     grid[tuple(pos[i] for i in rest)].reshape(-1))

    def group(self, axis=None):
        """This rank's process group along ``axis`` (a name, a tuple of
        names, or the whole mesh for ``None``); ``None`` for a single rank,
        which needs no collective. The groups of every single axis and of
        the whole mesh are made at the first call; a tuple's at its own."""
        if self._groups is None:
            if not _dist().is_initialized():
                raise RuntimeError(
                    "a mesh of several ranks runs in a torch.distributed "
                    "world: call repro_torch.sharding.init_world (or "
                    "torch.distributed.init_process_group) on every rank")
            self._groups = {}
            for name in self.axis_names + (None,):
                self._groups[name] = self._group_over(name)
        if axis not in self._groups:
            self._groups[axis] = self._group_over(axis)
        return self._groups[axis]

    def _group_over(self, axis):
        ranks = self.axis_ranks(axis)
        return _group_of(ranks) if len(ranks) > 1 else None

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.devices.tolist()})"


@dataclasses.dataclass(frozen=True)
class ShardedRun:
    """A chains × data placement plan over a mesh of ranks.

    Attributes
    ----------
    mesh : Mesh
        Two-axis mesh ``(chain_axis, data_axis)`` of ranks. Build one with
        :meth:`plan` unless you already have a mesh.
    chain_axis, data_axis : str
        Mesh axis names (defaults ``"chains"`` / ``"data"``).
    shard_sites : tuple of str
        Names of bound-data arrays to partition along their leading axis
        over ``data_axis``. Empty means chains-only sharding (every rank
        holds the full data).
    """

    mesh: "object"
    chain_axis: str = "chains"
    data_axis: str = "data"
    shard_sites: Tuple[str, ...] = ()

    def __post_init__(self):
        names = tuple(self.mesh.axis_names)
        for ax in (self.chain_axis, self.data_axis):
            if ax not in names:
                raise ValueError(
                    f"mesh axes {names} do not include '{ax}'; a ShardedRun "
                    f"mesh needs both '{self.chain_axis}' and "
                    f"'{self.data_axis}' axes (size 1 is fine)")
        object.__setattr__(self, "shard_sites",
                           tuple(str(s) for s in self.shard_sites))
        if self.num_data_shards > 1 and not self.shard_sites:
            raise ValueError(
                f"mesh has {self.num_data_shards} '{self.data_axis}' shards "
                "but shard_sites is empty — name the observed arrays to "
                "partition, or use a data axis of size 1")

    # -- factories ---------------------------------------------------------
    @classmethod
    def plan(cls, *, data_shards: int = 1,
             devices: Optional[Sequence[int]] = None,
             chain_axis: str = "chains", data_axis: str = "data",
             shard_sites: Sequence[str] = ()) -> "ShardedRun":
        """Lay all (or the given) ranks out as chains × data.

        ``devices`` are ranks; by default every rank of the world, or rank
        0 alone when there is no world. ``data_shards`` ranks go to the
        data axis; every remaining rank to the chain axis. One rank yields
        the trivial 1×1 mesh and inference stays on the single-device path.
        """
        if devices is None:
            dist = _dist()
            devices = range(dist.get_world_size()
                            if dist.is_initialized() else 1)
        devs = [int(d) for d in np.asarray(list(devices)).reshape(-1)]
        n = len(devs)
        data_shards = int(data_shards)
        if data_shards < 1:
            raise ValueError("data_shards must be >= 1")
        if n % data_shards != 0:
            raise ValueError(
                f"{n} devices cannot be split into {data_shards} data "
                "shards; device count must be divisible by data_shards")
        grid = np.asarray(devs).reshape(n // data_shards, data_shards)
        return cls(Mesh(grid, (chain_axis, data_axis)),
                   chain_axis=chain_axis, data_axis=data_axis,
                   shard_sites=tuple(shard_sites))

    @classmethod
    def normalize(cls, mesh) -> Optional["ShardedRun"]:
        """Coerce a ``mesh=`` argument: None, a ShardedRun, or a mesh
        (anything with ``axis_names`` and ``devices``; wrapped chains-only,
        and a 'data' axis of size >1 without shard_sites is rejected by
        ``__post_init__``)."""
        if mesh is None:
            return None
        if isinstance(mesh, cls):
            return mesh
        names = tuple(getattr(mesh, "axis_names", ()))
        if not names:
            raise TypeError(f"mesh must be a ShardedRun or a Mesh, "
                            f"got {type(mesh).__name__}")
        chain_axis = names[0]
        if len(names) == 1:
            # single-axis mesh: reshape onto a (chains, 1) grid
            return cls.plan(devices=np.asarray(mesh.devices).reshape(-1),
                            chain_axis=chain_axis)
        return cls(mesh, chain_axis=chain_axis, data_axis=names[1])

    # -- geometry ----------------------------------------------------------
    def _axis_size(self, name: str) -> int:
        return dict(zip(self.mesh.axis_names,
                        self.mesh.devices.shape))[name]

    @property
    def num_chain_devices(self) -> int:
        return self._axis_size(self.chain_axis)

    @property
    def num_data_shards(self) -> int:
        return self._axis_size(self.data_axis)

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.mesh.devices.shape))

    @property
    def is_trivial(self) -> bool:
        """One device total: consumers use the plain single-device path."""
        return self.num_devices == 1

    def validate_chains(self, num_chains: int) -> None:
        if num_chains % self.num_chain_devices != 0:
            raise ValueError(
                f"num_chains={num_chains} is not divisible by the "
                f"{self.num_chain_devices}-device '{self.chain_axis}' mesh "
                "axis; pad the fleet or shrink the axis")

    # -- this rank ---------------------------------------------------------
    def coords(self) -> Tuple[int, int]:
        """This rank's (chain index, data index) on the mesh."""
        pos = self.mesh.coords()
        names = tuple(self.mesh.axis_names)
        return (pos[names.index(self.chain_axis)],
                pos[names.index(self.data_axis)])

    def chain_rows(self, num_chains: int) -> slice:
        """This rank's rows of a fleet of ``num_chains`` chains."""
        local = num_chains // self.num_chain_devices
        start = self.coords()[0] * local
        return slice(start, start + local)

    def device(self, device=None) -> torch.device:
        """This rank's device: ``device`` as given (``None`` means CUDA,
        and raises when CUDA is missing); a CUDA device without an index
        is the card ``local_rank % device_count`` (the rank's index among
        its host's ranks, :func:`~repro_torch.sharding.world.local_rank`),
        so ranks that share one card all take it."""
        from repro_torch.sharding.world import local_rank

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda",
                               local_rank() % torch.cuda.device_count())
        return dev

    @property
    def backend(self) -> Optional[str]:
        """The world's backend (``"gloo"`` or ``"nccl"``); None without a
        world."""
        dist = _dist()
        return dist.get_backend() if dist.is_initialized() else None

    # -- collectives over the mesh -----------------------------------------
    def gather_chains(self, tensors: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Each tensor of this rank's chain block (chain axis first) as the
        whole fleet's, in chain order: ONE all-gather along the chain axis
        of every tensor packed as bytes."""
        from repro_torch.sharding import world

        group = self.mesh.group(self.chain_axis)
        if group is None:
            return dict(tensors)
        names = list(tensors)
        local = tensors[names[0]].shape[0]
        cols = [tensors[k].contiguous().reshape(local, -1).view(torch.uint8)
                for k in names]
        parts = world.all_gather(torch.cat(cols, dim=1), group,
                                 self.chain_axis)
        axis = self.mesh.axis_ranks(self.chain_axis)
        by_rank = dict(zip(sorted(axis), parts))
        full = torch.cat([by_rank[r] for r in axis], dim=0)
        out, at = {}, 0
        for k, col in zip(names, cols):
            t = tensors[k]
            width = col.shape[1]
            out[k] = full[:, at:at + width].contiguous().view(t.dtype).reshape(
                (full.shape[0],) + tuple(t.shape[1:]))
            at += width
        return out

    def any_chains(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of this rank's chain axis."""
        from repro_torch.sharding import world
        group = self.mesh.group(self.chain_axis)
        if group is None:
            return bool(flag)
        return world.any_flag(flag, group, self.chain_axis)

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        from repro_torch.sharding import world
        group = self.mesh.group(None)
        if group is not None:
            world.barrier(group)

    # -- identity ----------------------------------------------------------
    def fingerprint(self) -> Tuple:
        """Hashable placement identity for ``ProgramKey.sharding``.

        Mesh shape + axis names + sharded sites: everything that changes a
        program (its collectives, its per-shard shapes). Ranks are
        deliberately NOT included, as ``repro`` leaves device ids out; a
        program that bakes this rank's rows keys on :meth:`coords` too.
        """
        return ("mesh", tuple(self.mesh.devices.shape),
                (self.chain_axis, self.data_axis), self.shard_sites)

    def __repr__(self):
        return (f"ShardedRun({self.chain_axis}={self.num_chain_devices} x "
                f"{self.data_axis}={self.num_data_shards}, "
                f"shard_sites={list(self.shard_sites)}, "
                f"backend={self.backend or 'none (no world)'})")


_tls = threading.local()


def active_run() -> Optional[ShardedRun]:
    """The plan of the mesh run in progress on this thread, if any."""
    return getattr(_tls, "run", None)


@contextlib.contextmanager
def use_run(plan: Optional[ShardedRun]):
    """Make ``plan`` (or no plan) the active one inside the block."""
    prev = getattr(_tls, "run", None)
    _tls.run = plan
    try:
        yield plan
    finally:
        _tls.run = prev
