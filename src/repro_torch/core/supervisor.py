"""Crash-only backend supervision (paper §5).

The backend is stateless by design: if the daemon faults, a host
supervisor rapidly restarts it while frontend stubs transparently retry
their requests, converting potential failures into transient latency
spikes. The idempotency table is intentionally lost on restart —
retried writes re-execute, preserving at-least-once semantics.

Restart race (fixed): a `kill_backend()` that lands during the
`restart_delay_s` sleep of an in-progress restart used to crash the
*dying* backend — a no-op — and the signal was lost: the fresh backend
swapped in alive and the intended second restart never happened. The
kill path now records a pending kill whenever the current backend is
already down, and the watcher applies it to the fresh backend at swap
time (then polls the *fresh* backend's liveness like any other), so
every crash signal produces exactly one restart.

A copy of ``repro.core.supervisor``, whole.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from repro_torch.core.backend import NexusBackend


class Supervisor:
    def __init__(self, factory: Callable[[], NexusBackend],
                 poll_interval_s: float = 0.001,
                 restart_delay_s: float = 0.002):
        self._factory = factory
        self._poll = poll_interval_s
        #: restart cost — public so fault schedules can retune it
        self.restart_delay_s = restart_delay_s
        self._backend = factory()
        self._running = False
        self._thread: threading.Thread | None = None
        self.restarts = 0
        self._lock = threading.Lock()
        self._pending_kill = False

    @property
    def backend(self) -> NexusBackend:
        with self._lock:
            return self._backend

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="nexus-supervisor")
        self._thread.start()

    def _watch(self) -> None:
        while self._running:
            be = self.backend
            if not be.alive:
                time.sleep(self.restart_delay_s)     # restart cost
                fresh = self._factory()
                with self._lock:
                    # carry over arena registry? NO — crash-only: fresh
                    # state; frontends re-drive in-flight transfers.
                    # A kill that raced the restart window targets the
                    # successor: apply it now, and let the next poll of
                    # the *fresh* backend's liveness restart again.
                    if self._pending_kill:
                        self._pending_kill = False
                        fresh.crash()
                    self._backend = fresh
                self.restarts += 1
            time.sleep(self._poll)

    def kill_backend(self) -> None:
        """Fault injection entry point used by tests/benchmarks.

        Exactly-one-restart contract: if the current backend is already
        down (a restart is in flight), the signal is queued for the
        successor instead of being absorbed by the corpse.
        """
        with self._lock:
            be = self._backend
            if not be.alive:
                self._pending_kill = True
                return
            be.crash()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=1.0)
        self.backend.shutdown()
