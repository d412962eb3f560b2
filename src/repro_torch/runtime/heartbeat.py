"""Host heartbeat tracking -> failed-host detection, as
``repro.runtime.heartbeat`` (host-only).

At 1000+ nodes, host failure is routine, not exceptional. Each host
records a heartbeat every step (in production: a lightweight KV store or
coordinator RPC; here: an injectable clock, unit-testable). The monitor
flags hosts whose last beat is older than ``timeout_s`` — the trainer then
triggers checkpoint-restore onto an elastic re-mesh (see ``elastic``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

__all__ = ["HeartbeatMonitor"]


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, timeout_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None):
        self.num_hosts = num_hosts
        self.timeout_s = timeout_s
        self._clock = clock or time.monotonic
        now = self._clock()
        self._last: Dict[int, float] = {h: now for h in range(num_hosts)}

    def beat(self, host_id: int) -> None:
        self._last[host_id] = self._clock()

    def failed_hosts(self) -> List[int]:
        now = self._clock()
        return [h for h, t in sorted(self._last.items())
                if now - t > self.timeout_s]

    def alive_hosts(self) -> List[int]:
        dead = set(self.failed_hosts())
        return [h for h in range(self.num_hosts) if h not in dead]

    def all_alive(self) -> bool:
        return not self.failed_hosts()
