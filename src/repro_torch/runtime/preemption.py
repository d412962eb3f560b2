"""Preemption handling: signal -> graceful final checkpoint, as
``repro.runtime.preemption``.

Cloud TPU/GPU fleets deliver SIGTERM (or a maintenance-event notice)
before reclaiming a node. The handler turns that into a cooperative flag
the training loop polls once per step; on the flagged step the loop
writes a synchronous final checkpoint and exits 0 — the scheduler then
restarts the job, which resumes from that step.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    def __init__(self, signals: Optional[Iterable[int]] = None,
                 install: bool = True):
        self._event = threading.Event()
        self._prev = {}
        if install:
            for sig in (signals or (signal.SIGTERM, signal.SIGINT)):
                try:
                    self._prev[sig] = signal.signal(sig, self._on_signal)
                except (ValueError, OSError):
                    pass  # non-main thread / unsupported platform

    def _on_signal(self, signum, frame):
        del frame
        self._event.set()

    def trigger(self) -> None:
        """Manual trigger (tests / maintenance-event pollers)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    # context manager: restores the previous signal handlers on exit, so
    # a scoped `with PreemptionHandler() as ph:` cannot leak handlers
    # into later code (e.g. pytest's own SIGINT handling)
    def __enter__(self) -> "PreemptionHandler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()
