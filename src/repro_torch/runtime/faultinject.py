"""Deterministic fault injection for robustness tests, as
``repro.runtime.faultinject``.

Three fault families, matching the failure modes the segmented driver
(``repro_torch.infer.driver``) must survive:

* **NaN densities** — :class:`NaNInjector` wraps any TransitionKernel
  sampler and poisons the float leaves of the kernel state at a fixed
  set of iteration indices. The poisoning is device work on a counter
  that rides along in the kernel state (``torch.where``, no host read),
  so a poisoned transition is still captured and replayed as a CUDA
  graph, and it exercises the real detection path: the host only sees
  the segment's summary. Its ``reference_variant()`` is the same sampler
  with injection disabled, so the driver's fused→reference fallback
  genuinely repairs the run.
* **Preemption** — :class:`ScriptedPreemption` quacks like
  ``PreemptionHandler`` but flips after a fixed number of polls instead
  of on a signal; deterministic in-process stand-in for SIGTERM.
* **Torn checkpoints** — :func:`torn_save` kills the checkpoint writer
  (via :class:`SimulatedKill`) at a chosen point in the commit protocol,
  leaving exactly the on-disk wreckage a mid-write crash leaves.

Everything here is deterministic: faults fire at scripted iterations /
poll counts, never at random, so every failing test replays exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.ckpt.checkpoint import save

__all__ = ["NaNInjector", "ScriptedPreemption", "SimulatedKill", "torn_save"]


class SimulatedKill(BaseException):
    """Raised to simulate the writer process dying mid-checkpoint.

    Derives from BaseException so that ordinary ``except Exception``
    cleanup inside the save path cannot swallow the "kill".
    """


def torn_save(directory: str, step: int, tree, *,
              kill_at: str = "before_commit") -> None:
    """Run the atomic save protocol but die at ``kill_at``.

    ``kill_at="before_rename"`` leaves only a ``step_N.tmp`` dir;
    ``kill_at="before_commit"`` leaves a fully renamed ``step_N`` dir
    WITHOUT the COMMITTED marker. Both must be invisible to
    ``restore``/``latest_step``.
    """
    if kill_at not in ("before_rename", "before_commit"):
        raise ValueError(f"unknown kill point {kill_at!r}")

    def _die(path):
        raise SimulatedKill(f"writer killed at {kill_at} ({path})")

    try:
        save(directory, step, tree, hooks={kill_at: _die})
    except SimulatedKill:
        pass
    else:
        raise AssertionError("torn_save hook did not fire")


class ScriptedPreemption:
    """PreemptionHandler stand-in that preempts after N polls.

    ``after_polls=2`` means the first two ``.preempted`` reads return
    False and every later read returns True — i.e. the driver completes
    two segments, then receives the "node reclaimed" notice.
    """

    def __init__(self, after_polls: int):
        self.after_polls = int(after_polls)
        self.polls = 0

    @property
    def preempted(self) -> bool:
        self.polls += 1
        return self.polls > self.after_polls

    def trigger(self) -> None:
        self.after_polls = 0

    def uninstall(self) -> None:
        pass

    def __enter__(self) -> "ScriptedPreemption":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


@dataclasses.dataclass
class NaNInjector:
    """Sampler wrapper that poisons kernel state at fixed iterations.

    Satisfies the TransitionKernel-factory protocol by delegating to
    ``inner`` and wrapping the resulting kernel: state becomes
    ``(t, inner_state)`` where ``t`` is a 0-d int32 device tensor counting
    transitions (all chains run in lockstep, so one counter serves them),
    and after each transition every float leaf is overwritten with NaN iff
    ``t`` is in ``at_iterations`` (kept as a sorted tuple, so that the
    sampler's fingerprint, and with it its cached programs, follows its
    content).
    """

    inner: object
    at_iterations: Tuple[int, ...] = ()
    enabled: bool = True

    def __init__(self, inner, at_iterations: Iterable[int] = (),
                 enabled: bool = True):
        self.inner = inner
        self.at_iterations = tuple(sorted({int(i) for i in at_iterations}))
        self.enabled = enabled

    @property
    def uses_potential_spec(self) -> bool:
        return bool(getattr(self.inner, "uses_potential_spec", False))

    def reference_variant(self) -> "NaNInjector":
        """Fallback twin: same state structure, injection off."""
        from repro_torch.infer.driver import reference_variant
        ref_inner = reference_variant(self.inner) or self.inner
        return NaNInjector(ref_inner, self.at_iterations, enabled=False)

    def make_kernel(self, logdensity, dim: int, spec: Optional[object] = None,
                    spec_reason: Optional[str] = None):
        if self.uses_potential_spec:
            k = self.inner.make_kernel(logdensity, dim, spec=spec,
                                       spec_reason=spec_reason)
        else:
            k = self.inner.make_kernel(logdensity, dim)
        hits = self.at_iterations
        poison = self.enabled and bool(hits)

        def _maybe_poison(t, tree):
            if not poison:
                return tree
            hit = t == hits[0]
            for h in hits[1:]:
                hit = hit | (t == h)

            def leaf(x):
                if not (torch.is_tensor(x) and x.is_floating_point()):
                    return x
                return torch.where(hit, torch.full_like(x, float("nan")), x)

            return tree_map(leaf, tree)

        def init(q0):
            return (torch.zeros((), dtype=torch.int32, device=q0.device),
                    k.init(q0))

        def warm(state, t, generator):
            t_count, s = state
            s = _maybe_poison(t_count, k.warm(s, t, generator))
            return (t_count + 1, s)

        def finalize(state):
            t_count, s = state
            return (t_count, k.finalize(s))

        def step(state, generator):
            t_count, s = state
            s, out = k.step(s, generator)
            s = _maybe_poison(t_count, s)
            out = _maybe_poison(t_count, out)
            return (t_count + 1, s), out

        return k._replace(init=init, warm=warm, finalize=finalize, step=step)
