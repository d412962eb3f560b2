"""Chain container, MCMC diagnostics, and the multi-chain runner.

Three layers:

* ``Chain`` + ``effective_sample_size`` / ``split_rhat`` — posterior draw
  storage with a leading chain axis and the standard mixing diagnostics
  (NumPy, identical to the JAX package's).
* ``TransitionKernel`` — the protocol every MCMC sampler exposes through
  ``make_kernel(logdensity, dim)``: ``init``/``warm``/``finalize``/``step``
  functions over a flat unconstrained state written out as
  ``(num_chains, dim)``, drawing their noise from an explicit
  ``torch.Generator``.
* ``run_chains`` — the many-chains-on-one-device runner: takes the
  model's fused flat log-density (and, for a sampler that asks, its
  (conditionally) separable spec) from the program cache
  (``core/program.py``), so a repeated call on the same model and layout
  builds neither again, advances all chains in lockstep (one kernel
  launch per density family per step, or one fused leapfrog per
  transition, for the whole chain axis), and packages the draws back
  through the typed trace.
* ``TransitionPrograms`` — a kernel's warm and step transitions as two
  ``CompiledProgram`` s over the loop's buffers, cached by
  ``run_chains``: on CUDA each is captured as a graph and replayed once a
  transition, as ``repro`` runs the chain loop under ``jax.jit``. The
  warmup iteration ``t`` and the draw index are device tensors advanced
  inside the programs, and each draw is written into preallocated
  ``(num_chains, num_samples, ...)`` buffers, so a replay needs no host
  work beyond its launch; the draws stay on the device until packaging.
  ``start`` and ``advance`` run the loop in pieces (a :class:`ChainRun`),
  which is how the segmented driver (``infer.driver``) runs it.
* ``setup_chain_driver`` — the preamble both drivers share: the one
  generator, the trace, the cached programs and the jittered inits.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch._device import resolve_device
from repro_torch.core.program import (CompiledProgram, GraphPool, ProgramKey,
                                      cached_potential, density_program,
                                      disable_capture, kernel_fingerprint,
                                      model_fingerprint, program_cache,
                                      trace_fingerprint, write_into)
from repro_torch.sharding.mesh import ShardedRun, active_run, use_run

__all__ = ["Chain", "ChainRun", "TransitionKernel", "TransitionPrograms",
           "chain_draw", "drive_chains", "effective_sample_size",
           "package_draws", "run_chains", "setup_chain_driver", "split_rhat"]


def _fmt(v, width: int, prec: int) -> str:
    """Fixed-width float cell; non-finite renders as an explicit marker
    (``n/a``) instead of a bare ``nan`` so degenerate diagnostics are
    visible at a glance."""
    v = float(v)
    if np.isnan(v):
        return f"{'n/a':>{width}}"
    return f"{v:>{width}.{prec}f}"


class Chain:
    """Posterior draws: dict name -> (num_chains, num_samples, ...) arrays.

    Single-chain results are stored with a leading chain axis of 1.
    ``health`` (optional) is the :class:`~repro_torch.infer.driver.
    ChainHealth` report the driver produced; ``summary()`` appends it when
    present.
    """

    def __init__(self, draws: Dict[str, Any],
                 stats: Optional[Dict[str, Any]] = None, health=None):
        self.draws = {k: np.asarray(v) for k, v in draws.items()}
        self.stats = {k: np.asarray(v) for k, v in (stats or {}).items()}
        self.health = health
        first = next(iter(self.draws.values()))
        self.num_chains, self.num_samples = first.shape[0], first.shape[1]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.draws[name]

    def names(self):
        return list(self.draws)

    def flat(self, name: str) -> np.ndarray:
        """(num_chains*num_samples, ...) view of a variable."""
        v = self.draws[name]
        return v.reshape((-1,) + v.shape[2:])

    def mean(self, name: str):
        return self.flat(name).mean(axis=0)

    def std(self, name: str):
        return self.flat(name).std(axis=0)

    def to_dict_of_flat(self) -> Dict[str, np.ndarray]:
        return {n: self.flat(n) for n in self.names()}

    def summary(self) -> str:
        has_div = "diverging" in self.stats
        n_div = int(np.sum(self.stats["diverging"])) if has_div else 0
        header = f"{'param':<18}{'mean':>12}{'std':>12}{'ess':>10}{'rhat':>8}"
        if has_div:
            header += f"{'div':>6}"
        lines = [header]
        for n in self.names():
            v = self.draws[n]
            scalar = v.reshape(v.shape[0], v.shape[1], -1)[..., 0]
            ess = effective_sample_size(scalar)
            rhat = split_rhat(scalar)
            row = (f"{n:<18}{_fmt(self.mean(n).ravel()[0], 12, 4)}"
                   f"{_fmt(self.std(n).ravel()[0], 12, 4)}"
                   f"{_fmt(ess, 10, 1)}{_fmt(rhat, 8, 3)}")
            if has_div:
                row += f"{n_div:>6d}"
            lines.append(row)
        if self.health is not None:
            lines += ["", self.health.report()]
        return "\n".join(lines)

    def __repr__(self):
        return (f"Chain(chains={self.num_chains}, samples={self.num_samples}, "
                f"vars={self.names()})")


def _autocov(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    x = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n].real
    return acov / n


def effective_sample_size(x: np.ndarray) -> float:
    """Geyer initial-monotone ESS for (chains, samples) scalar draws.

    Degenerate inputs — fewer than 4 draws per chain, or zero variance
    (a constant / fully stuck chain) — have no defined ESS; those cases
    return ``nan`` WITH an explicit ``RuntimeWarning`` naming the cause
    rather than silently propagating ``nan`` arithmetic."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    if n < 4:
        warnings.warn(
            f"effective_sample_size is undefined for {n} draws per chain "
            "(need >= 4); returning nan", RuntimeWarning, stacklevel=2)
        return float("nan")
    acov = _autocov(x)
    mean_var = acov[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if not np.isfinite(var_plus) or var_plus <= 1e-300:
        warnings.warn(
            "effective_sample_size is undefined for zero-variance or "
            "non-finite draws (constant / stuck chain?); returning nan",
            RuntimeWarning, stacklevel=2)
        return float("nan")
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    # Geyer initial-positive-monotone sequence over lag pairs
    prev_pair = np.inf
    tau = 1.0
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)  # initial monotone
        prev_pair = pair
        tau += 2.0 * pair
        t += 2
    return float(m * n / max(tau, 1e-12))


def split_rhat(x: np.ndarray) -> float:
    """Split-chain potential scale reduction factor.

    Degenerate inputs warn explicitly instead of silently returning a
    bare ``nan``: fewer than 4 draws per chain -> ``nan``; zero variance
    everywhere (all chains constant at one point) -> ``nan``; zero
    within-chain variance but distinct chain means (chains stuck at
    DIFFERENT points — the worst possible mixing) -> ``inf``."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    m, n = x.shape
    half = n // 2
    if half < 2:
        warnings.warn(
            f"split_rhat is undefined for {n} draws per chain (need >= 4 "
            "to split); returning nan", RuntimeWarning, stacklevel=2)
        return float("nan")
    halves = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    m2, n2 = halves.shape
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = n2 * chain_means.var(ddof=1)
    if not np.isfinite(w) or w <= 1e-300:
        if not np.isfinite(b) or b <= 1e-300:
            warnings.warn(
                "split_rhat is undefined for zero-variance draws (all "
                "chains constant); returning nan",
                RuntimeWarning, stacklevel=2)
            return float("nan")
        warnings.warn(
            "split_rhat: zero within-chain variance with distinct chain "
            "means (chains stuck at different points); returning inf",
            RuntimeWarning, stacklevel=2)
        return float("inf")
    var_plus = (n2 - 1.0) / n2 * w + b / n2
    return float(np.sqrt(var_plus / w))


# ---------------------------------------------------------------------------
# multi-chain runner
# ---------------------------------------------------------------------------
class TransitionKernel(NamedTuple):
    """MCMC transition kernel over a flat unconstrained state.

    Samplers build one via ``make_kernel(logdensity, dim)``. Every state
    tensor carries the chain axis first: positions are ``(num_chains, dim)``.

    Attributes
    ----------
    init : callable
        ``q0 (num_chains, dim) -> state``; evaluates whatever the sampler
        caches (log-density, gradient, adaptation state).
    warm : callable
        ``(state, t, generator) -> state``; one warmup transition at
        iteration ``t`` (a float32 0-d tensor on the chains' device),
        including any step-size adaptation.
    finalize : callable
        ``state -> state``; freezes adapted quantities before sampling.
        ``run_chains`` calls it only after a non-empty warmup.
    step : callable
        ``(state, generator) -> (state, out)`` with ``out`` a dict of
        per-draw tensors, each ``(num_chains, ...)``, that MUST contain
        ``"q"`` and ``"logp"``; extra keys become ``Chain.stats``.
    spec_reason : str, optional
        Why the fused-integrator spec could NOT be compiled for
        this kernel (``None`` when a spec is in use or was never wanted):
        the diagnosis from ``repro_torch.core.potential``, so that a
        ``leapfrog="auto"`` fallback is explained instead of silent.
    capturable : bool
        Whether ``warm`` and ``step`` may be recorded as CUDA graphs: no
        host read of a device value, every draw from the generator they
        are given. NUTS reads its loop tests on the host and captures its
        leaf iterations instead.
    programs : tuple
        The kernel's own ``CompiledProgram`` s (NUTS's tree programs), for
        the cache's counters.
    """

    init: Callable
    warm: Callable
    finalize: Callable
    step: Callable
    spec_reason: Optional[str] = None
    capturable: bool = True
    programs: tuple = ()


def package_draws(tvi_linked, qs: torch.Tensor,
                  stats: Optional[Dict[str, Any]] = None) -> Chain:
    """Map flat unconstrained draws back to constrained named arrays.

    Parameters
    ----------
    tvi_linked : TypedVarInfo
        Linked typed trace fixing the flat layout of ``qs``.
    qs : tensor, shape ``(num_chains, num_samples, num_flat)``
        Unconstrained draws.
    stats : dict of tensors, optional
        Per-draw sampler statistics, each ``(num_chains, num_samples, ...)``.

    Returns
    -------
    Chain
        NumPy draws keyed by site symbol, each
        ``(num_chains, num_samples) + site.shape`` on the constrained
        support (a double ``vmap`` of ``replace_flat().invlink()``, one
        cached ``"package"`` program).
    """
    # cached on the trace FINGERPRINT (layout + dist parameters): the
    # invlink bakes the stored dists' parameters (e.g. Uniform bounds), so
    # equal-layout traces with different dist params get programs apart
    key = ProgramKey(trace_fingerprint(tvi_linked), "package",
                     tvi_linked.layout, (), "fused", ())

    def build():
        def to_constrained(q):
            return tvi_linked.replace_flat(q).invlink().as_dict()

        # once a run, its output goes straight to the host: a graph would
        # only hold a second copy of the draws
        return CompiledProgram(
            key, lambda q: torch.func.vmap(torch.func.vmap(to_constrained))(q),
            jit=False)

    draws = program_cache().get_or_build(key, build)(qs)

    def host(v):
        # a copy: run_chains' draws are buffers the next run overwrites
        return (v.detach().to("cpu", copy=True).numpy() if torch.is_tensor(v)
                else np.asarray(v))

    return Chain({k: host(v) for k, v in draws.items()},
                 stats={k: host(v) for k, v in (stats or {}).items()})


def chain_draw(fn: Callable, shape, **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)`` (``torch.randn`` or ``torch.rand``, with the
    run's generator in ``kwargs``) for the chains ``shape[0]`` of a run.

    Under a chains mesh (an active ``ShardedRun`` with several chain
    devices, ``sharding.use_run``) every rank draws the whole fleet's
    ``(num_chains,) + shape[1:]`` and keeps its own rows, so a sharded run
    draws what the unsharded one does, and every rank's generator stays in
    the same state."""
    run = active_run()
    if run is None or run.num_chain_devices == 1:
        return fn(shape, **kwargs)
    fleet = (shape[0] * run.num_chain_devices,) + tuple(shape[1:])
    return fn(fleet, **kwargs)[run.chain_rows(fleet[0])]


def setup_chain_driver(seed: int, model, kernel, *, num_chains: int,
                       init_varinfo=None, init_jitter: float = 1.0,
                       backend: str = "fused", ctx=None, device=None,
                       plan: Optional[ShardedRun] = None):
    """Shared preamble of the single-run and segmented drivers.

    Seeds the run's ONE ``torch.Generator`` (on ``device``) with ``seed``,
    draws the discovery trace from it (unless ``init_varinfo`` is given),
    links it, takes the fused log-density (and, for a sampler that asks,
    its (conditionally) separable spec) from the program cache, builds or
    reuses the sampler's cached :class:`TransitionPrograms`, and draws the
    per-chain init jitter. Everything after it draws from the generator in
    a fixed order, transition by transition: this derivation is THE
    contract both drivers share, and what makes a segmented run equal to
    an unsegmented one bit for bit under the same seed.

    With a mesh ``plan`` (called inside ``use_run(plan)``) the device is
    this rank's, the chains this rank's block of the fleet (their jitter
    its rows of the fleet's draw), and on a data mesh the density is
    :func:`~repro_torch.sharding.make_sharded_logdensity`'s, with no
    separable spec (its integrator cannot hold the collective). Every
    program's key holds the plan's fingerprint.

    Returns ``(tvi_linked, programs, dim, q0s, generator)``.
    """
    from repro_torch.core.varinfo import assert_continuous_supports

    dev = resolve_device(device) if plan is None else plan.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    tvi = (init_varinfo if init_varinfo is not None
           else model.typed_varinfo(gen))
    assert_continuous_supports(tvi, type(kernel).__name__)
    tvi = tvi.link()
    on_data = plan is not None and plan.num_data_shards > 1
    if on_data:
        from repro_torch.core.contexts import DefaultContext
        from repro_torch.sharding.data_parallel import make_sharded_logdensity
        if ctx is not None and ctx != DefaultContext():
            raise ValueError(
                "a data-sharded run splits the joint density into prior and "
                f"likelihood; it takes no ctx (got {type(ctx).__name__})")
        logdensity = make_sharded_logdensity(model, tvi, plan,
                                             backend=backend, device=dev)
    else:
        # density + potential spec come from the ProgramCache: repeated
        # calls on the same (model, layout, ctx, backend) build neither
        # again, and so pay no compiler probes
        logdensity = density_program(model, tvi, ctx=ctx, backend=backend)
    dim = int(tvi.num_flat)

    def make_kern():
        if not getattr(kernel, "uses_potential_spec", False):
            return kernel.make_kernel(logdensity, dim)
        if on_data:
            return kernel.make_kernel(
                logdensity, dim, spec=None,
                spec_reason="the fused integrator is skipped on a "
                "data-sharded mesh: its spec cannot hold the all-reduce")
        res = cached_potential(model, tvi, ctx=ctx, backend=backend)
        return kernel.make_kernel(logdensity, dim, spec=res.spec,
                                  spec_reason=res.reason)

    kfp = kernel_fingerprint(kernel)
    if kfp is None:  # an opaque kernel: no key can tell two apart
        progs = TransitionPrograms(make_kern())
    else:
        from repro_torch.core.contexts import DefaultContext
        from repro_torch.kernels import fused_logpdf_enabled
        # the transition does not depend on num_warmup or num_samples; on
        # a mesh its draws and data are this rank's (coordinates in the
        # tail)
        extra = (ctx if ctx is not None else DefaultContext(), kfp,
                 fused_logpdf_enabled())
        if plan is not None:
            extra += (("rank", plan.coords()),)
        key = ProgramKey(model_fingerprint(model), "transition", tvi.layout,
                         (int(num_chains),), backend, extra,
                         plan.fingerprint() if plan is not None else ())
        progs = program_cache().get_or_build(
            key, lambda: TransitionPrograms(make_kern(), key))

    local = num_chains // (plan.num_chain_devices if plan is not None else 1)
    q0s = tvi.flat().to(dev).expand(local, dim)
    if init_jitter:
        u = chain_draw(torch.rand, (local, dim), generator=gen, device=dev)
        q0s = q0s + (2.0 * u - 1.0) * init_jitter
    return tvi, progs, dim, q0s, gen


def _mesh_plan(mesh, num_chains: int) -> Optional[ShardedRun]:
    """``run_chains``' ``mesh=`` as a plan: ``None`` for no mesh or a
    trivial (one-device) one, which keeps the single-device path; the
    fleet must split evenly over the chain axis, and the mesh's process
    groups are made (every rank of the mesh calls this together)."""
    plan = ShardedRun.normalize(mesh)
    if plan is not None and plan.is_trivial:
        plan = None  # graceful degradation: one device == no mesh
    if plan is not None:
        plan.validate_chains(num_chains)
        if not callable(getattr(plan.mesh, "group", None)):
            raise TypeError(
                "a mesh run lays the fleet over ranks: give it a "
                "repro_torch.sharding.Mesh (or ShardedRun.plan()), not a "
                f"{type(plan.mesh).__name__}")
        plan.mesh.group()  # the world and this rank's groups, up front
    return plan


def _on_data_mesh(plan: Optional[ShardedRun]):
    """Eager inside the block on a data mesh: a gloo collective goes
    through the host, and a CUDA graph cannot hold it."""
    if plan is not None and plan.num_data_shards > 1:
        return disable_capture()
    return contextlib.nullcontext()


def run_chains(seed: int, model, kernel, num_samples: int, *,
               num_warmup: int = 0, num_chains: int = 4, init_varinfo=None,
               init_jitter: float = 1.0, backend: str = "fused", ctx=None,
               device=None, mesh=None, checkpoint_dir: Optional[str] = None,
               checkpoint_every: Optional[int] = None,
               checkpoint_keep: int = 3, preemption=None,
               fallback: bool = True) -> Chain:
    """Run ``num_chains`` MCMC chains in lockstep on one device, or over a
    mesh of ranks.

    The model's log-density is built once from the typed trace (fused
    flat-buffer backend by default), kept in the program cache for later
    calls, and shared by every chain. A kernel
    with ``uses_potential_spec`` also gets the model's (conditionally)
    separable spec (or the compiler's reason why there is none). Each
    transition advances the whole ``(num_chains, dim)`` state: either the
    density's value and gradient run under ``torch.func.vmap`` over the
    chain axis, so each density family is one kernel launch for all
    chains, or the whole n-step leapfrog is one ``fused_leapfrog`` launch.

    Parameters
    ----------
    seed : int
        Seeds the ONE ``torch.Generator`` (on ``device``) that draws the
        discovery trace, the init jitter, and every momentum and accept
        uniform. Same seed, same device: the same chains. The potential
        compiler's probes draw from a generator of their own, so
        ``leapfrog="auto"`` and ``"reference"`` consume the same draws.
    model : repro_torch.core.model.Model
        Bound model to sample from; its data must live on ``device``.
    kernel : HMC | NUTS | RWMH
        Any sampler exposing ``make_kernel(logdensity, dim)``; one whose
        ``uses_potential_spec`` is true is called with ``spec=`` and
        ``spec_reason=`` too.
    num_samples, num_warmup : int
        Post-warmup draws per chain, and discarded warmup iterations.
    num_chains : int
        Number of chains (the leading axis of every result).
    init_varinfo : TypedVarInfo, optional
        Typed trace to initialise from; discovered from the prior if absent.
    init_jitter : float
        Half-width of the per-chain Uniform jitter around the discovery
        draw in UNCONSTRAINED space. ``0.0`` starts every chain at the same
        point.
    backend : {"fused", "reference"}
        Log-density backend (see ``Model.make_logdensity_fn``).
    ctx : Context, optional
        Evaluation context for the log-density (default: the joint).
    device : str or torch.device, optional
        Where the chains run; ``None`` means ``"cuda"`` and raises when
        CUDA is missing. Pass ``"cpu"`` to run on the CPU. On a mesh, a
        CUDA device without an index is the rank's card.
    mesh : ShardedRun or Mesh, optional
        Placement plan over a mesh of ranks
        (``repro_torch.sharding.ShardedRun``), in a ``torch.distributed``
        world of one process a rank: every rank of the mesh calls
        ``run_chains`` with the same arguments. With a non-trivial chains
        axis each rank runs its block of the fleet; every rank draws the
        whole fleet's randomness from the one generator and keeps its
        rows, so the draws are the unsharded run's. With ``data`` shards
        > 1 the plan's ``shard_sites`` arrays are partitioned along their
        leading axis, each rank evaluates its shard's likelihood, and one
        all-reduce a gradient evaluation joins them (the separable spec
        is skipped, and the transitions run eagerly: a gloo collective
        goes through the host). Every rank returns the whole fleet's
        ``Chain`` (one all-gather). A trivial (one-device) plan or
        ``None`` keeps the single-device path bit for bit.
        ``num_chains`` must be divisible by the chains-axis size.
        Composes with checkpointing for chains-only plans.
    checkpoint_dir : str, optional
        Directory for atomic keep-N ``RunState`` snapshots. Setting it
        (or ``checkpoint_every`` / ``preemption``) switches to the
        SEGMENTED driver (``repro_torch.infer.driver``): the loop runs in
        ``checkpoint_every``-sized segments, snapshots between them, and
        RESUMES from the latest committed snapshot when one exists (same
        seed required), bit for bit as the uninterrupted run.
    checkpoint_every : int, optional
        Segment length in transitions (warmup + sampling). Defaults to
        a tenth of the total when only ``checkpoint_dir`` is given.
    checkpoint_keep : int
        Keep-N retention for committed snapshots.
    preemption : PreemptionHandler, optional
        Polled between segments; on preemption the driver writes a final
        synchronous checkpoint and returns the partial chain cleanly.
        When ``checkpoint_dir`` is set and this is ``None``, the driver
        installs its own SIGTERM/SIGINT handler for the duration.
    fallback : bool
        Segmented driver only: rerun a segment whose state went NaN on the
        sampler's reference twin (autodiff leapfrog, per-site densities),
        recording the event in ``Chain.health``.

    Returns
    -------
    Chain
        Draws of shape ``(num_chains, num_samples) + site.shape`` per site;
        ``stats`` holds ``logp`` and the kernel's extras (accept_prob,
        diverging); ``health`` carries the ``ChainHealth`` report (with
        the program cache's hits, misses and new signatures of this run,
        in this rank's cache).
    """
    plan = _mesh_plan(mesh, num_chains)
    if (checkpoint_dir is not None or checkpoint_every is not None
            or preemption is not None):
        from repro_torch.infer.driver import run_segmented
        return run_segmented(
            seed, model, kernel, num_samples, num_warmup=num_warmup,
            num_chains=num_chains, init_varinfo=init_varinfo,
            init_jitter=init_jitter, backend=backend, ctx=ctx,
            device=device, mesh=plan, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, preemption=preemption,
            fallback=fallback)

    from repro_torch.infer.driver import health_from_stats

    cache = program_cache()
    stats0 = cache.stats()
    with use_run(plan):
        tvi, progs, _, q0s, gen = setup_chain_driver(
            seed, model, kernel, num_chains=num_chains,
            init_varinfo=init_varinfo, init_jitter=init_jitter,
            backend=backend, ctx=ctx, device=device, plan=plan)
        with _on_data_mesh(plan):
            qs, stats = drive_chains(progs.kern, q0s, gen,
                                     num_warmup=num_warmup,
                                     num_samples=num_samples, programs=progs)
        if plan is not None:
            stats = plan.gather_chains({"q": qs, **stats})
            qs = stats.pop("q")
    chain = package_draws(tvi, qs, stats=stats)
    chain.health = health_from_stats(chain.stats, num_warmup=num_warmup,
                                     num_samples=num_samples,
                                     num_chains=num_chains)
    s1 = cache.stats()
    chain.health.cache_hits = max(0, s1["hits"] - stats0["hits"])
    chain.health.cache_misses = max(0, s1["misses"] - stats0["misses"])
    chain.health.cache_retraces = max(0, s1["retraces"] - stats0["retraces"])
    return chain


def _record(draws: Dict[str, torch.Tensor], out, idx: torch.Tensor,
            axis: int) -> None:
    """Write one draw's stats into ``draws`` at the device index ``idx``
    along the draws axis."""
    for k, buf in draws.items():
        buf.index_copy_(axis, idx, out[k].unsqueeze(axis).to(buf.dtype))


class TransitionPrograms:
    """A :class:`TransitionKernel` 's chain init, warm and step transitions
    as programs over the loop's buffers, and those buffers.

    ``init(q0s)`` returns the initial state (fresh tensors);
    ``warm(state, t, generator)`` runs one warmup transition and advances
    the float32 0-d ``t``; ``step(state, draws, idx, generator)`` runs one
    sampling transition, writes its stats into ``draws`` at the int64
    ``(1,)`` index ``idx`` and advances it. Both write the state in place
    (donated arguments), so on CUDA a transition is one graph replay with
    no host work beyond the launch. The buffers are kept per state
    signature and reused by the next run, so every replay reads and
    writes the tensors its graph recorded; the draw buffers are kept for
    one draw count only: a run at another count frees them and the step
    graph that writes them (at gaussian_10k's 4 x 10,000 float32 and
    2,000 draws, ``q`` alone is 320 MB). The three programs capture into
    one :class:`~repro_torch.core.program.GraphPool`. A kernel that is not
    ``capturable`` runs both eagerly.
    """

    def __init__(self, kern: TransitionKernel,
                 key: Optional[ProgramKey] = None):
        key = key if key is not None else ProgramKey(
            ("uncached",), "transition", None, (), "", ())
        self.kern = kern
        self.pool = GraphPool()
        self.init = CompiledProgram(key._replace(kind="init"), kern.init,
                                    jit=kern.capturable, pool=self.pool)
        self.warm = CompiledProgram(key._replace(kind="warm"), self._warm,
                                    jit=kern.capturable,
                                    donate_argnums=(0, 1), pool=self.pool)
        self.step = CompiledProgram(key._replace(kind="step"), self._step,
                                    jit=kern.capturable,
                                    donate_argnums=(0, 1, 2), pool=self.pool)
        self._buffers = {}

    @property
    def programs(self):
        return (self.init, self.warm, self.step) + tuple(self.kern.programs)

    def _warm(self, state, t, generator):
        write_into(state, self.kern.warm(state, t, generator))
        t.add_(1.0)

    def _step(self, state, draws, idx, generator):
        new, out = self.kern.step(state, generator)
        write_into(state, new)
        # the draws axis: after the chain axis of logp's (chains, draws)
        _record(draws, out, idx, draws["logp"].dim() - 1)
        idx.add_(1)

    def start(self, q0s: torch.Tensor, *, num_warmup: int,
              num_samples: int) -> "ChainRun":
        """Chain init from ``q0s`` into this object's buffers for the state
        signature, with ``t`` and the draw index at 0: a run at iteration
        0 of ``num_warmup + num_samples``. The draw buffers of another
        draw count go, with the step graph that writes them; those of
        this count are kept (and overwritten)."""
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        leaves, spec = tree_flatten(self.init(q0s))
        skey = (spec, tuple((tuple(x.shape), x.dtype, x.device)
                            for x in leaves))
        bufs = self._buffers.get(skey)
        dev = q0s.device
        if bufs is None:
            bufs = self._buffers[skey] = {
                "state": [x.clone() for x in leaves], "draws": None,
                "t": torch.zeros((), dtype=torch.float32, device=dev),
                "idx": torch.zeros((1,), dtype=torch.int64, device=dev)}
        else:
            write_into(bufs["state"], leaves)
        bufs["t"].zero_()
        bufs["idx"].zero_()
        axis = q0s.dim() - 1
        draws = bufs["draws"]
        if draws is not None and \
                next(iter(draws.values())).shape[axis] != num_samples:
            # another draw count: its buffers and the step graph that
            # writes them go before the new ones are made
            bufs["draws"] = None
            self.step.forget()
        return ChainRun(bufs, spec, axis, int(num_warmup), int(num_samples))

    def advance(self, run: "ChainRun", generator: torch.Generator,
                stop: int) -> None:
        """Run transitions ``run.it`` up to ``stop`` (warmup, then
        sampling) over ``run`` 's buffers, which may be another
        ``TransitionPrograms`` ' (a sampler's reference twin reruns a
        segment on them). The adapted quantities are frozen
        (``finalize``) once, just before the first sampling transition,
        whichever segment it starts. The first draw of a run whose draw
        buffers do not exist yet runs eagerly and sizes them."""
        kern, state = self.kern, run.state
        t, idx, axis = run.t, run.idx, run.axis
        for i in range(run.it, stop):
            if i < run.num_warmup:
                self.warm(state, t, generator)
                continue
            if i == run.num_warmup and run.num_warmup > 0:
                # freeze adapted quantities only when adaptation actually
                # ran: dual averaging's smoothed iterate starts at 1.0
                write_into(state, kern.finalize(state))
            draws = run.bufs["draws"]
            if draws is None:
                new, out = kern.step(state, generator)
                write_into(state, new)
                run.bufs["draws"] = {
                    k: torch.empty(v.shape[:axis] + (run.num_samples,)
                                   + v.shape[axis:], dtype=v.dtype,
                                   device=v.device) for k, v in out.items()}
                _record(run.bufs["draws"], out, idx, axis)
                idx.add_(1)
            else:
                self.step(state, draws, idx, generator)
        run.it = stop

    def run(self, q0s: torch.Tensor, generator: torch.Generator, *,
            num_warmup: int, num_samples: int):
        """Warmup then sampling from ``q0s``; returns ``(state, draws)``:
        the final state and each stat's ``(..., num_samples, ...)`` buffer
        (the draws axis after the chain axis, first for a ``(dim,)``
        state). Both are this object's buffers, which the next run on the
        same shapes overwrites."""
        run = self.start(q0s, num_warmup=num_warmup, num_samples=num_samples)
        self.advance(run, generator, num_warmup + num_samples)
        return run.state, run.draws


class ChainRun:
    """The buffers of one run of :class:`TransitionPrograms` and how far
    it is: ``it`` transitions done of ``num_warmup + num_samples``.

    ``state`` is the sampler state over the state buffers; ``t`` (float32,
    0-d) the warmup iteration and ``idx`` (int64, ``(1,)``) the next draw,
    both advanced on the device; ``draws`` each stat's buffer (``None``
    until the run's first draw sizes them)."""

    def __init__(self, bufs: dict, spec, axis: int, num_warmup: int,
                 num_samples: int):
        self.bufs = bufs
        self.state = tree_unflatten(bufs["state"], spec)
        self.axis = axis
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.it = 0

    @property
    def t(self) -> torch.Tensor:
        return self.bufs["t"]

    @property
    def idx(self) -> torch.Tensor:
        return self.bufs["idx"]

    @property
    def draws(self) -> Optional[Dict[str, torch.Tensor]]:
        return self.bufs["draws"]

    def seek(self, it: int) -> None:
        """Set ``it``, ``t`` and ``idx`` to iteration ``it`` (a resume, or
        a segment rerun from its start)."""
        self.it = int(it)
        self.t.fill_(float(min(it, self.num_warmup)))
        self.idx.fill_(max(0, it - self.num_warmup))


def drive_chains(kern: TransitionKernel, q0s: torch.Tensor,
                 generator: torch.Generator, *, num_warmup: int,
                 num_samples: int,
                 programs: Optional[TransitionPrograms] = None):
    """Run warmup then sampling for all chains of ``q0s (num_chains, dim)``.

    Returns ``(qs, stats)``: ``qs (num_chains, num_samples, dim)`` and each
    per-draw stat as ``(num_chains, num_samples, ...)``. Nothing in the
    loop waits for the device: draws stay on it until packaging. The
    transitions run through ``programs`` (``run_chains`` passes its cached
    ones, whose buffers the returned draws are) or through new
    :class:`TransitionPrograms` of ``kern``.
    """
    progs = programs if programs is not None else TransitionPrograms(kern)
    _, draws = progs.run(q0s, generator, num_warmup=num_warmup,
                         num_samples=num_samples)
    stats = dict(draws)
    return stats.pop("q"), stats
