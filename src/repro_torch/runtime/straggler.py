"""Straggler detection: per-step median-ratio streaks + EWMA summaries, as
``repro.runtime.straggler`` (host-only).

In synchronous SPMD training one slow host gates every step (the
collective waits). Detection must be robust at small host counts — a
z-score against fleet std self-inflates when the outlier is IN the fleet —
so we flag a host when its RAW step time exceeds ``ratio`` x the fleet
median for ``patience`` CONSECUTIVE steps. Transient blips (GC pause,
checkpoint write) last a step or two and reset the streak; genuine
stragglers (thermal throttling, dying HBM, noisy neighbour) persist.

Mitigation is the caller's policy — log + alert, then exclude the host at
the next elastic re-mesh (in sync SPMD you cannot drop a shard mid-run).
``summary()`` exposes per-host EWMA step times for dashboards.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

__all__ = ["StragglerDetector"]


@dataclasses.dataclass
class _HostStat:
    ewma: float = 0.0
    initialized: bool = False
    flag_streak: int = 0


class StragglerDetector:
    def __init__(self, num_hosts: int, alpha: float = 0.2,
                 ratio: float = 1.5, patience: int = 5,
                 min_steps: int = 5):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.ratio = ratio
        self.patience = patience
        self.min_steps = min_steps
        self._stats: Dict[int, _HostStat] = {
            h: _HostStat() for h in range(num_hosts)}
        self._steps = 0

    def record_step(self, durations_s: Dict[int, float]) -> None:
        """Per-host wall time of the step just finished."""
        self._steps += 1
        for h, d in durations_s.items():
            st = self._stats[h]
            if not st.initialized:
                st.ewma, st.initialized = d, True
            else:
                st.ewma = (1 - self.alpha) * st.ewma + self.alpha * d
        if self._steps < self.min_steps or not durations_s:
            return
        med = statistics.median(durations_s.values())
        for h, d in durations_s.items():
            st = self._stats[h]
            if med > 0 and d > self.ratio * med:
                st.flag_streak += 1
            else:
                st.flag_streak = 0

    def stragglers(self) -> List[int]:
        return [h for h, st in sorted(self._stats.items())
                if st.flag_streak >= self.patience]

    def summary(self) -> Dict[int, float]:
        return {h: st.ewma for h, st in self._stats.items() if st.initialized}
