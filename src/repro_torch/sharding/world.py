"""The world a mesh runs in: one process a rank, on ``torch.distributed``.

``repro`` drives a device mesh from one controller; the port runs one
process a rank, and every rank calls the same entry points with the same
arguments (:mod:`repro_torch.sharding.mesh`).

* :func:`init_world` joins the calling process to a world and picks its
  backend: NCCL when each rank has a card of its own, gloo when ranks
  share one card or run on the CPU (gloo takes CUDA tensors through the
  host).
* :func:`spawn_world` runs a function on every rank of a new world of
  spawned processes on this host and returns what each returned; a rank
  that fails or a world that outlives its time limit is killed, whole,
  and raises.
* The collectives the port makes (:func:`all_reduce`,
  :func:`all_gather`, :func:`any_flag`, :func:`barrier`) go through here,
  counted per mesh axis in :data:`COLLECTIVES` and timed on the host in
  :data:`COLLECTIVE_S` (a gloo collective of CUDA tensors waits for the
  card, so its time includes the copies through the host). gloo takes
  the CUDA tensors of all-reduce and all-gather as they are (held on the
  card by ``chip_smoke.py``'s phase 6g), so nothing is staged here.

On the CPU: ``spawn_world(fn, 4, device="cpu")`` (a gloo world over a
``FileStore`` in a temporary directory).
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["COLLECTIVES", "COLLECTIVE_S", "all_gather", "all_reduce",
           "any_flag", "barrier", "init_world", "local_rank",
           "reset_collective_counts", "spawn_world"]

# mesh axis -> collectives since the last reset, and host seconds in them
COLLECTIVES: Dict[str, int] = {}
COLLECTIVE_S: Dict[str, float] = {}
# this rank's index among its host's ranks, once init_world has run
_LOCAL_RANK: Optional[int] = None


def _dist():
    import torch.distributed as dist
    return dist


def reset_collective_counts() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_S.clear()


def local_rank() -> int:
    """This rank's index among its host's ranks: what :func:`init_world`
    was given, else ``LOCAL_RANK`` (set by ``torchrun``), else the world
    rank (0 without a world)."""
    if _LOCAL_RANK is not None:
        return _LOCAL_RANK
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def init_world(rank: int, world_size: int, *, store=None,
               init_method: Optional[str] = None, device=None,
               timeout_s: float = 300.0, local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None) -> str:
    """Join this process to a world of ``world_size`` ranks as ``rank``;
    returns the backend.

    ``store`` (a ``torch.distributed`` store, e.g. a ``FileStore``) or
    ``init_method`` (``"tcp://localhost:<port>"``, ``"file://..."``) says
    where the ranks meet. ``device`` is where the ranks run (``None``
    means CUDA, and raises when CUDA is missing). The backend and the
    card follow this host's ranks: ``local_rank`` of ``local_world_size``
    (by default ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` as ``torchrun``
    sets them, else ``rank`` of ``world_size``: a world on one host). On
    the CPU, or when the host has fewer cards than its ranks, the backend
    is gloo; with a card a rank it is NCCL, and the rank takes card
    ``local_rank % device_count``.
    """
    global _LOCAL_RANK
    from repro_torch._device import resolve_device

    env = os.environ
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dist = _dist()
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        backend = "nccl"
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=store, init_method=init_method, rank=int(rank),
        world_size=int(world_size),
        timeout=datetime.timedelta(seconds=timeout_s))
    _LOCAL_RANK = int(local_rank)
    return backend


def _count(label: str, t0: float) -> None:
    COLLECTIVES[label] = COLLECTIVES.get(label, 0) + 1
    COLLECTIVE_S[label] = COLLECTIVE_S.get(label, 0.0) + (
        time.perf_counter() - t0)


def all_reduce(t: torch.Tensor, group, label: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    dist = _dist()
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    _count(label, t0)
    return t


def all_gather(t: torch.Tensor, group, label: str) -> List[torch.Tensor]:
    """``t`` of every rank of ``group``, in the group's rank order (its
    ranks sorted)."""
    dist = _dist()
    t0 = time.perf_counter()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    _count(label, t0)
    return parts


def any_flag(flag: bool, group, label: str) -> bool:
    """Whether ``flag`` holds on any rank of ``group``: a host value, so
    gloo reduces it on the CPU and NCCL on this rank's card."""
    dist = _dist()
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    _count(label, t0)
    return bool(t.item())


def barrier(group) -> None:
    _dist().barrier(group=group)


# ---------------------------------------------------------------------------
# a world of spawned processes
# ---------------------------------------------------------------------------
def _rank_main(fn, rank, world_size, store_path, device, timeout_s, args,
               results):
    dist = _dist()
    try:
        init_world(rank, world_size,
                   store=dist.FileStore(store_path, world_size),
                   device=device, timeout_s=timeout_s)
        out = fn(rank, world_size, *args)
        results.put((rank, True, out))
        dist.barrier()
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn: Callable, world_size: int, *, args=(), device=None,
                timeout_s: float = 600.0, store_dir: Optional[str] = None
                ) -> list:
    """Run ``fn(rank, world_size, *args)`` on each rank of a new world of
    ``world_size`` spawned processes; returns each rank's result, by rank.

    ``fn`` must be importable by name (a module-level function) and its
    results picklable. The ranks meet through a ``FileStore`` in
    ``store_dir`` (a new temporary directory by default, removed after),
    joined by :func:`init_world` with ``device``
    (``"cpu"`` for a gloo world on the CPU). If a rank raises or exits,
    or the world is not done within ``timeout_s`` seconds, every rank is
    killed and this raises ``RuntimeError`` (with the rank's traceback)
    or ``TimeoutError``; no process outlives the call.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = None if store_dir else tempfile.mkdtemp(prefix="repro_torch_world_")
    store = os.path.join(store_dir or tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, store, device, timeout_s,
                               tuple(args), results))
             for rank in range(world_size)]
    done: Dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world_size} ranks not done in {timeout_s} "
                    f"s; ranks {sorted(set(range(world_size)) - set(done))} "
                    "were still running and were killed")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                for rank, p in enumerate(procs):
                    if rank not in done and p.exitcode is not None:
                        raise RuntimeError(
                            f"rank {rank} of {world_size} exited with code "
                            f"{p.exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            done[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world_size)]
