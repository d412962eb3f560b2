"""Segmented, resumable, fault-tolerant multi-chain driver, as
``repro.infer.driver``.

``run_segmented`` is the checkpointed sibling of the single-run
``run_chains`` path. The warmup+sampling loop is cut into
``checkpoint_every``-sized segments of the SAME transitions
(``infer.chains.TransitionPrograms``: on the card each transition is one
replay of its CUDA graph) over the same buffers. Between segments the
host

* snapshots a :class:`RunState` through the atomic keep-N
  ``repro_torch.ckpt`` layer (each leaf copied to the host once, then
  written by a background thread; ``COMMITTED`` marker last, torn
  snapshots ignored on restore),
* polls a :class:`~repro_torch.runtime.preemption.PreemptionHandler` and
  on preemption writes a final SYNCHRONOUS checkpoint and returns the
  partial chain cleanly (exit-0 semantics: the scheduler restarts the job
  and the next ``run_chains`` call resumes), and
* runs chain-health guard rails — NaN state, divergence counts, stuck
  chains (zero acceptance), straggler-style log-density outliers — into a
  :class:`ChainHealth` report attached to the returned ``Chain``. The
  segment's summary is reduced on the device; one ``(4, num_chains)``
  tensor crosses to the host a segment.

Graceful degradation: a segment whose state goes NaN is rerun once from
the pre-segment state (the state, the draw index and the generator's
state) on :func:`reference_variant` of the sampler (autodiff leapfrog,
per-site densities), and the fallback is recorded in the report.

Bit-exactness, stronger than ``repro``'s: the run draws from ONE
``torch.Generator`` in a fixed order, transition by transition
(``setup_chain_driver``), and replays graphs that equal their eager runs
bit for bit over deterministic kernels. So a segmented run equals the
unsegmented ``run_chains`` bit for bit, and a run interrupted and resumed
from its latest committed snapshot — whose ``RunState`` holds the
generator's state — equals the uninterrupted one, even in a fresh process
or after ``clear_cache()``. The adapted step size is frozen just before
the first sampling transition, so a snapshot taken at the end of warmup
holds the state before ``finalize``.

On a chains mesh (``mesh=``, a chains-only ``ShardedRun``) each rank runs
its block of the fleet through the same segments. Snapshots are
placement-agnostic: the fleet's state and draws are gathered, the mesh's
first rank writes them, and every rank restores its rows of the latest
one, behind a barrier; the generator's state is the same on every rank
(each draws the fleet's randomness). The segment summaries, and so the
guard rails, the fallback and the preemption poll, are the fleet's.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer,
                                         _flatten_with_paths, latest_step,
                                         read_meta, restore, save)
from repro_torch.infer.chains import (Chain, TransitionPrograms, _mesh_plan,
                                      package_draws, setup_chain_driver)
from repro_torch.runtime.preemption import PreemptionHandler
from repro_torch.sharding.mesh import ShardedRun, use_run

__all__ = ["ChainHealth", "RunState", "health_from_stats",
           "reference_variant", "run_segmented"]


class RunState(NamedTuple):
    """The complete, checkpointable state of a segmented run.

    Everything needed to continue the run lives here — restoring it and
    the generator's state reproduces the remaining draws bit for bit.
    ``q_buf`` and ``stat_bufs`` are ``None`` until the first draw."""

    iteration: Any        # () int64 — completed warmup+sampling transitions
    kernel_state: Any     # the sampler's state (leading chain axis)
    q_buf: Any            # (chains, num_samples, dim) unconstrained draws
    stat_bufs: Any        # dict name -> (chains, num_samples, ...) stats
    counters: Any         # dict: health counters accumulated so far
    generator: Any        # uint8: the run's torch.Generator state


@dataclasses.dataclass
class ChainHealth:
    """Guard-rail report for a (possibly partial) multi-chain run."""

    num_chains: int
    target_warmup: int
    target_samples: int
    completed: int                  # warmup+sampling transitions done
    divergences: np.ndarray         # (chains,) divergent-draw counts
    nonfinite: np.ndarray           # (chains,) non-finite segment events
    stuck: Tuple[int, ...] = ()     # chains with a zero-acceptance streak
    outliers: Tuple[int, ...] = ()  # straggler-style log-density outliers
    fallback_segments: int = 0      # segments rerun on the reference path
    preempted: bool = False
    resumed_from: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    cache_hits: int = 0             # ProgramCache hits during this run
    cache_misses: int = 0           # programs built during this run
    cache_retraces: int = 0         # new signatures of cached programs
    snapshots: int = 0              # snapshots taken by this process
    snapshot_bytes: int = 0         # their bytes, copied to the host
    snapshot_s: float = 0.0         # host seconds taking them (copies)
    snapshot_write_s: float = 0.0   # seconds writing them (writer thread
                                    # and the final synchronous saves)

    @property
    def completed_samples(self) -> int:
        return max(0, self.completed - self.target_warmup)

    @property
    def ok(self) -> bool:
        return (not self.preempted and not self.stuck and not self.outliers
                and int(np.sum(self.nonfinite)) == 0
                and self.completed == self.target_warmup + self.target_samples)

    def report(self) -> str:
        lines = [f"chain health: {'OK' if self.ok else 'ISSUES'}"]
        lines.append(
            f"  draws {self.completed_samples}/{self.target_samples} per "
            f"chain x {self.num_chains} chains "
            f"(+{min(self.completed, self.target_warmup)}/"
            f"{self.target_warmup} warmup)")
        n_div = int(np.sum(self.divergences))
        if n_div:
            per = ", ".join(str(int(d)) for d in self.divergences)
            lines.append(f"  divergences: {n_div} (per chain: {per})")
        if int(np.sum(self.nonfinite)):
            bad = [i for i, c in enumerate(self.nonfinite) if c]
            lines.append(f"  non-finite state events in chains {bad}")
        if self.fallback_segments:
            lines.append(f"  fused->reference fallback on "
                         f"{self.fallback_segments} segment(s)")
        if self.stuck:
            lines.append(f"  stuck chains (zero acceptance): "
                         f"{list(self.stuck)}")
        if self.outliers:
            lines.append(f"  outlier chains (log-density far from fleet "
                         f"median): {list(self.outliers)}")
        if self.preempted:
            where = (f"; resumable from {self.checkpoint_dir}"
                     if self.checkpoint_dir else "")
            lines.append(f"  PREEMPTED at iteration {self.completed}{where}")
        if self.resumed_from is not None:
            lines.append(f"  resumed from committed iteration "
                         f"{self.resumed_from}")
        if self.cache_hits or self.cache_misses or self.cache_retraces:
            lines.append(f"  program cache: {self.cache_hits} hit(s), "
                         f"{self.cache_misses} miss(es), "
                         f"{self.cache_retraces} retrace(s)")
        return "\n".join(lines)


class _GuardRails:
    """Streak-based stuck/outlier detection over per-segment summaries.

    Mirrors ``runtime.straggler``: robust at small chain counts (a
    median/MAD test instead of a self-inflating z-score) and requiring
    ``patience`` CONSECUTIVE flagged segments so a transient blip (one
    hard region of the posterior) does not flag a healthy chain.
    """

    def __init__(self, num_chains: int, stuck_accept: float = 1e-3,
                 outlier_scale: float = 10.0, patience: int = 3):
        self.stuck_accept = stuck_accept
        self.outlier_scale = outlier_scale
        self.patience = patience
        self._stuck_streak = np.zeros(num_chains, np.int64)
        self._out_streak = np.zeros(num_chains, np.int64)

    def record(self, accept_mean: np.ndarray, logp_mean: np.ndarray) -> None:
        flag = ~np.isfinite(accept_mean) | (accept_mean < self.stuck_accept)
        self._stuck_streak = np.where(flag, self._stuck_streak + 1, 0)
        finite = np.isfinite(logp_mean)
        if finite.any():
            med = np.median(logp_mean[finite])
            mad = np.median(np.abs(logp_mean[finite] - med))
            thr = self.outlier_scale * (mad + 1e-3) + 1.0
            out = ~finite | (np.abs(logp_mean - med) > thr)
        else:
            out = np.ones_like(finite)
        self._out_streak = np.where(out, self._out_streak + 1, 0)

    def stuck(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in
                     np.nonzero(self._stuck_streak >= self.patience)[0])

    def outliers(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in
                     np.nonzero(self._out_streak >= self.patience)[0])


def reference_variant(sampler):
    """Best-effort reference-backend twin of ``sampler``.

    The twin must produce a kernel with the SAME state structure (so a
    mid-run state carries over) but no fused kernels anywhere — the
    graceful-degradation target when the fused path goes NaN. Returns
    ``None`` when the sampler is already fully on the reference path
    (nothing to fall back to) or cannot be rebuilt.
    """
    custom = getattr(sampler, "reference_variant", None)
    if callable(custom):
        return custom()
    if not dataclasses.is_dataclass(sampler):
        return None
    fields = {f.name for f in dataclasses.fields(sampler)}
    changes = {}
    if "leapfrog" in fields and sampler.leapfrog != "reference":
        changes["leapfrog"] = "reference"
    if "backend" in fields and sampler.backend != "reference":
        changes["backend"] = "reference"
    if not changes:
        return None
    return dataclasses.replace(sampler, **changes)


def health_from_stats(stats: Dict[str, np.ndarray], *, num_warmup: int,
                      num_samples: int, num_chains: int,
                      stuck_accept: float = 1e-3,
                      outlier_scale: float = 10.0) -> ChainHealth:
    """Post-hoc ChainHealth for the single-run driver (whole run = one
    segment's worth of evidence, so streaks degenerate to one test)."""
    logp = np.asarray(stats.get("logp", np.zeros((num_chains, 0))))
    div = stats.get("diverging")
    divergences = (np.asarray(div).astype(np.int64).sum(axis=1)
                   if div is not None else np.zeros(num_chains, np.int64))
    nonfinite = (~np.isfinite(logp)).any(axis=1).astype(np.int64) \
        if logp.size else np.zeros(num_chains, np.int64)
    rails = _GuardRails(num_chains, stuck_accept=stuck_accept,
                        outlier_scale=outlier_scale, patience=1)
    acc = stats.get("accept_prob")
    if acc is not None and logp.size:
        rails.record(np.asarray(acc).mean(axis=1), logp.mean(axis=1))
    return ChainHealth(
        num_chains=num_chains, target_warmup=num_warmup,
        target_samples=num_samples, completed=num_warmup + num_samples,
        divergences=divergences, nonfinite=nonfinite,
        stuck=rails.stuck(), outliers=rails.outliers())


def _check_meta(saved: Dict, want: Dict, directory: str) -> None:
    keys = ("format", "num_chains", "num_warmup", "num_samples", "dim",
            "sampler", "seed", "backend")
    bad = [k for k in keys if saved.get(k) != want.get(k)]
    if bad:
        detail = {k: (saved.get(k), want.get(k)) for k in bad}
        raise ValueError(
            f"checkpoint in {directory} is from a different run "
            f"configuration; mismatched (saved, requested): {detail}. "
            "Resuming would NOT reproduce the original draws — point "
            "checkpoint_dir at a fresh directory or rerun with the "
            "original arguments/seed.")


def _nan_rows(x: torch.Tensor, num_chains: int) -> torch.Tensor:
    """(num_chains,) bool: which chains' rows of ``x`` hold a NaN (a leaf
    without the chain axis flags every chain). NaN — not inf — is the
    trigger: an impossible state has logp == -inf, a blown-up kernel NaN."""
    nan = torch.isnan(x)
    if x.dim() >= 1 and x.shape[0] == num_chains:
        return nan.reshape(num_chains, -1).any(dim=1)
    return nan.any().expand(num_chains)


def _segment_summary(run, num_chains: int, d0: int, d1: int,
                     plan: Optional[ShardedRun] = None) -> Dict:
    """The segment's health summary, reduced on the device, as host arrays
    (one copy): per chain, NaN in the state or in the segment's draws, and
    for a sampling segment (``d1 > d0``) the mean log-density, the mean
    acceptance and the divergences of draws ``d0:d1``. ``num_chains`` are
    this rank's; on a mesh the summary is gathered into the fleet's."""
    floats = [x for x in tree_flatten(run.state)[0]
              if torch.is_tensor(x) and x.is_floating_point()]
    dev = floats[0].device
    bad = torch.zeros(num_chains, dtype=torch.bool, device=dev)
    for x in floats:
        bad = bad | _nan_rows(x, num_chains)
    rows = [None, torch.full((num_chains,), float("nan"), device=dev),
            torch.ones(num_chains, device=dev),
            torch.zeros(num_chains, device=dev)]
    if d1 > d0:
        seg = {k: v[:, d0:d1] for k, v in run.draws.items()}
        for v in seg.values():
            if v.is_floating_point():
                bad = bad | _nan_rows(v, num_chains)
        rows[1] = seg["logp"].to(torch.float32).mean(dim=1)
        if "accept_prob" in seg:
            rows[2] = seg["accept_prob"].to(torch.float32).mean(dim=1)
        if "diverging" in seg:
            rows[3] = seg["diverging"].to(torch.float32).sum(dim=1)
    rows[0] = bad.to(torch.float32)
    table = torch.stack(rows)
    if plan is not None:
        table = plan.gather_chains({"t": table.T.contiguous()})["t"].T
    host = table.cpu().numpy()
    return {"bad": host[0] > 0, "logp_mean": host[1].astype(np.float64),
            "acc_mean": host[2].astype(np.float64),
            "div": host[3].astype(np.int64)}


def run_segmented(seed: int, model, sampler, num_samples: int, *,
                  num_warmup: int = 0, num_chains: int = 4,
                  init_varinfo=None, init_jitter: float = 1.0,
                  backend: str = "fused", ctx=None, device=None, mesh=None,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: Optional[int] = None,
                  checkpoint_keep: int = 3, preemption=None,
                  fallback: bool = True, stuck_accept: float = 1e-3,
                  outlier_scale: float = 10.0, patience: int = 3) -> Chain:
    """Checkpointed, preemptible, health-guarded ``run_chains``.

    See the module docstring for the contract. Normally reached through
    ``repro_torch.infer.run_chains(..., checkpoint_dir=...,
    checkpoint_every=...)`` rather than called directly; the arguments
    are ``run_chains``'. ``mesh=`` shards chains only: a data-sharded plan
    raises ``ValueError``. ``ChainHealth.snapshot_bytes`` and
    ``snapshot_s`` count this process's snapshots and the host seconds
    their copies took.
    """
    if num_samples <= 0:
        raise ValueError("num_samples must be positive")
    total = num_warmup + num_samples
    seg = int(checkpoint_every) if checkpoint_every else max(1, total // 10)
    if seg <= 0:
        raise ValueError("checkpoint_every must be positive")

    plan = ShardedRun.normalize(mesh)
    if plan is not None and not plan.is_trivial and plan.num_data_shards > 1:
        raise ValueError(
            "the segmented driver shards chains only; data-parallel "
            "plans (data shards > 1) require the single-scan "
            "run_chains path (checkpointing disabled)")
    plan = _mesh_plan(plan, num_chains)
    with use_run(plan):
        return _run_segmented(
            seed, model, sampler, num_samples, num_warmup=num_warmup,
            num_chains=num_chains, init_varinfo=init_varinfo,
            init_jitter=init_jitter, backend=backend, ctx=ctx,
            device=device, plan=plan, checkpoint_dir=checkpoint_dir,
            seg=seg, checkpoint_keep=checkpoint_keep, preemption=preemption,
            fallback=fallback, stuck_accept=stuck_accept,
            outlier_scale=outlier_scale, patience=patience)


def _fleet(run, plan: Optional[ShardedRun], with_draws: bool):
    """The run's state leaves and (when ``with_draws``) its draw buffers,
    as the fleet's: this rank's own without a mesh, gathered (one
    all-gather) on one."""
    leaves, spec = tree_flatten(run.state)
    tensors = {f"s{i}": x for i, x in enumerate(leaves)
               if torch.is_tensor(x) and x.dim() >= 1}
    if with_draws:
        tensors.update({f"d:{k}": v for k, v in run.draws.items()})
    if plan is not None:
        tensors = plan.gather_chains(tensors)
    state = tree_unflatten([tensors.get(f"s{i}", x)
                            for i, x in enumerate(leaves)], spec)
    draws = ({k[2:]: v for k, v in tensors.items() if k.startswith("d:")}
             if with_draws else None)
    return state, draws


def _run_segmented(seed, model, sampler, num_samples, *, num_warmup,
                   num_chains, init_varinfo, init_jitter, backend, ctx,
                   device, plan, checkpoint_dir, seg, checkpoint_keep,
                   preemption, fallback, stuck_accept, outlier_scale,
                   patience) -> Chain:
    total = num_warmup + num_samples
    from repro_torch.core.program import program_cache
    cache = program_cache()
    cstats0 = cache.stats()

    tvi, progs, dim, q0s, gen = setup_chain_driver(
        seed, model, sampler, num_chains=num_chains,
        init_varinfo=init_varinfo, init_jitter=init_jitter, backend=backend,
        ctx=ctx, device=device, plan=plan)
    run = progs.start(q0s, num_warmup=num_warmup, num_samples=num_samples)
    local = q0s.shape[0]
    rows = plan.chain_rows(num_chains) if plan is not None else None
    # on a mesh, its first rank writes the fleet's snapshots
    writes = plan is None or plan.coords() == (0, 0)

    counters = {"nonfinite": np.zeros(num_chains, np.int64),
                "divergences": np.zeros(num_chains, np.int64),
                "fallbacks": np.zeros((), np.int64),
                "cache_misses": np.zeros((), np.int64),
                "cache_retraces": np.zeros((), np.int64)}
    meta = {"format": "run_chains/torch/1", "num_chains": int(num_chains),
            "num_warmup": int(num_warmup), "num_samples": int(num_samples),
            "dim": int(dim), "sampler": type(sampler).__name__,
            "backend": backend, "seed": int(seed)}

    # cache counters accumulate ACROSS resumes: the restored totals are
    # the base, this process's cache-stat delta is added on top at every
    # snapshot
    cache_base = {"misses": 0, "retraces": 0}

    def _sync_cache_counters():
        s = cache.stats()
        counters["cache_misses"] = np.int64(
            cache_base["misses"] + max(0, s["misses"] - cstats0["misses"]))
        counters["cache_retraces"] = np.int64(
            cache_base["retraces"]
            + max(0, s["retraces"] - cstats0["retraces"]))

    taken = {"n": 0, "bytes": 0, "s": 0.0, "write_s": 0.0}

    def _snapshot(it):
        # the live buffers (or on a mesh the fleet's, gathered): the
        # checkpointer copies each leaf to the host before it returns, so
        # the next segment may overwrite them
        _sync_cache_counters()
        state, draws = _fleet(run, plan, it > num_warmup)
        snap = RunState(
            np.int64(it), state, None if draws is None else draws["q"],
            None if draws is None else {k: v for k, v in draws.items()
                                        if k != "q"},
            {k: v.copy() for k, v in counters.items()}, gen.get_state())
        taken["n"] += 1
        taken["bytes"] += sum(
            x.numel() * x.element_size() if torch.is_tensor(x)
            else np.asarray(x).nbytes for _, x in _flatten_with_paths(snap))
        return snap

    def _timed(fn, *args, key="s", **kw):
        t0 = time.perf_counter()
        fn(*args, **kw)
        taken[key] += time.perf_counter() - t0

    it = 0
    resumed_from = None
    ckpt = None
    if checkpoint_dir:
        if writes:
            ckpt = AsyncCheckpointer(checkpoint_dir, keep=checkpoint_keep)
        last = latest_step(checkpoint_dir)
        if last is not None:
            _check_meta(read_meta(checkpoint_dir, last), meta, checkpoint_dir)
            _, flat = restore(checkpoint_dir, last)
            it = int(flat[".iteration"])
            _load(flat, run, it, gen, counters, rows)
            cache_base = {"misses": int(counters["cache_misses"]),
                          "retraces": int(counters["cache_retraces"])}
            resumed_from = it
        if plan is not None:  # every rank has read it before a write
            plan.barrier()

    own_handler = preemption is None and checkpoint_dir is not None
    if own_handler:
        preemption = PreemptionHandler()

    # graceful degradation target: same state structure, reference-only
    # numerics; built lazily (the fallback path is the cold path)
    ref_progs = None

    def _get_ref_progs():
        nonlocal ref_progs
        if ref_progs is not None:
            return ref_progs
        ref_progs = False
        ref_sampler = reference_variant(sampler)
        if ref_sampler is None:
            return ref_progs
        ld_ref = model.make_logdensity_fn(tvi, ctx=ctx, backend="reference")
        ref_kern = ref_sampler.make_kernel(ld_ref, dim)
        proto_leaves, proto_spec = tree_flatten(ref_kern.init(q0s))
        leaves, spec = tree_flatten(run.state)
        if proto_spec != spec or [tuple(x.shape) for x in proto_leaves] != \
                [tuple(x.shape) for x in leaves]:
            warnings.warn(
                "reference fallback disabled: reference kernel state "
                "structure differs from the primary kernel's",
                RuntimeWarning)
            return ref_progs
        ref_progs = TransitionPrograms(ref_kern)
        return ref_progs

    rails = _GuardRails(num_chains, stuck_accept=stuck_accept,
                        outlier_scale=outlier_scale, patience=patience)
    preempted = False

    try:
        while it < total:
            in_warmup = it < num_warmup
            end = min(it + seg, num_warmup if in_warmup else total)
            d0, d1 = max(0, it - num_warmup), max(0, end - num_warmup)
            if fallback:  # the pre-segment state, for a rerun
                pre = ([x.clone() for x in tree_flatten(run.state)[0]],
                       gen.get_state())
            progs.advance(run, gen, end)
            summ = _segment_summary(run, local, d0, d1, plan)
            if summ["bad"].any():
                counters["nonfinite"] += summ["bad"].astype(np.int64)
                rp = _get_ref_progs() if fallback else False
                if rp:
                    for x, old in zip(tree_flatten(run.state)[0], pre[0]):
                        x.copy_(old)
                    gen.set_state(pre[1])
                    run.seek(it)
                    rp.advance(run, gen, end)
                    summ = _segment_summary(run, local, d0, d1, plan)
                    counters["fallbacks"] = counters["fallbacks"] + 1
            if not in_warmup:
                counters["divergences"] += summ["div"]
                rails.record(summ["acc_mean"], summ["logp_mean"])
            it = end
            stop = preemption is not None and preemption.preempted
            if plan is not None:  # one rank's preemption stops the mesh
                stop = plan.any_chains(stop)
            if stop:
                preempted = True
                if checkpoint_dir:
                    snap = _snapshot(it)
                    if ckpt:
                        ckpt.wait()
                        _timed(save, checkpoint_dir, it, snap,
                               keep=checkpoint_keep, meta=meta,
                               key="write_s")
                break
            if checkpoint_dir:
                snap = _snapshot(it)
                if ckpt:
                    _timed(ckpt.save, it, snap, meta=meta)
        if checkpoint_dir and not preempted:
            if ckpt:
                ckpt.wait()
            # the writer decides; on a mesh every rank gathers the snapshot
            need = bool(ckpt) and latest_step(checkpoint_dir) != total
            if plan is not None:
                need = plan.any_chains(need)
            if need:
                snap = _snapshot(total)
                if ckpt:
                    _timed(save, checkpoint_dir, total, snap,
                           keep=checkpoint_keep, meta=meta, key="write_s")
    finally:
        if ckpt:
            ckpt.wait()
        if own_handler:
            preemption.uninstall()
    if plan is not None and checkpoint_dir:
        plan.barrier()  # the snapshots are on disk for every rank

    _sync_cache_counters()
    completed_samples = max(0, it - num_warmup)
    if completed_samples:
        draws = {k: v[:, :completed_samples] for k, v in run.draws.items()}
        if plan is not None:
            draws = plan.gather_chains(draws)
        chain = package_draws(tvi, draws.pop("q"), stats=draws)
    else:
        proto = tvi.invlink().as_dict()
        chain = Chain({k: np.zeros((num_chains, 0) + tuple(np.shape(v)))
                       for k, v in proto.items()})
    chain.health = ChainHealth(
        num_chains=num_chains, target_warmup=num_warmup,
        target_samples=num_samples, completed=it,
        divergences=counters["divergences"].copy(),
        nonfinite=counters["nonfinite"].copy(),
        stuck=rails.stuck(), outliers=rails.outliers(),
        fallback_segments=int(counters["fallbacks"]),
        preempted=preempted, resumed_from=resumed_from,
        checkpoint_dir=checkpoint_dir,
        cache_hits=max(0, cache.stats()["hits"] - cstats0["hits"]),
        cache_misses=int(counters["cache_misses"]),
        cache_retraces=int(counters["cache_retraces"]),
        snapshots=taken["n"], snapshot_bytes=taken["bytes"],
        snapshot_s=taken["s"],
        snapshot_write_s=taken["write_s"] + (ckpt.write_s if ckpt else 0.0))
    return chain


def _load(flat: Dict[str, np.ndarray], run, it: int,
          gen: torch.Generator, counters: Dict,
          rows: Optional[slice] = None) -> None:
    """Restore a snapshot (``restore``'s {path: array}) into the run's
    buffers, the generator and ``counters``; on a mesh, ``rows`` of the
    fleet's (chain axis first) into this rank's."""
    def mine(a):
        a = np.array(a)
        return a[rows] if rows is not None and a.ndim >= 1 else a

    for path, x in _flatten_with_paths(run.state, ".kernel_state"):
        x.copy_(torch.from_numpy(mine(flat[path])))
    if it > run.num_warmup:
        saved = {"q": mine(flat[".q_buf"])}
        prefix = ".stat_bufs["
        saved.update({p[len(prefix) + 1:-2]: mine(a)
                      for p, a in flat.items() if p.startswith(prefix)})
        dev = tree_flatten(run.state)[0][0].device
        draws = run.draws
        if draws is None or set(draws) != set(saved):
            run.bufs["draws"] = {
                k: torch.from_numpy(np.array(a)).to(dev)
                for k, a in saved.items()}
        else:
            for k, buf in draws.items():
                buf.copy_(torch.from_numpy(np.array(saved[k])))
    run.seek(it)
    gen.set_state(torch.from_numpy(np.array(flat[".generator"])))
    for k in counters:
        counters[k] = np.array(flat[f".counters[{k!r}]"])
