"""FaultPlane: deterministic fault injection as pure data (paper §5).

The paper's reliability story is *crash-only*: the shared backend is
stateless, a host supervisor restarts it on fault, frontend stubs
transparently retry, and per-logical-write PUT idempotency keys keep
at-least-once semantics. This module makes that story a first-class,
testable plane of the cost model — exactly like `plan.SystemSpec` made
variant structure data:

* a `FaultSpec` is one fault as a value: a backend crash at t, a
  storage tail-latency or error window, a dropped writeback ack, a
  failed snapshot restore, arena-slot exhaustion;
* a `FaultSchedule` composes specs (plus the recovery constants —
  restart delay, ack-redrive timeout) into one deterministic, seeded
  timeline BOTH executors consume from the same source of truth:

  - the threaded runtime is armed by `FaultInjector` through existing
    seams (`Supervisor.kill_backend`, `storage.FaultPlan` windows, the
    `FaultHooks` taps read by backend/lifecycle/client at call time,
    `ArenaRegistry` hog slots);
  - the DES interprets the same schedule inside its PlanProgram
    interpreter (`des.DensitySimulator(faults=...)`): crash events
    abort in-flight backend-group phases and re-queue them behind the
    restart delay, idempotent PUTs re-execute, and the retry work is
    charged to the simulator's `metrics.CycleAccount` books.

Per-variant failure semantics (the table README documents):

    offloaded fabric (nexus-*)  backend crash aborts only the in-flight
                                backend groups; the invocation survives
                                and retries behind `restart_delay_s`
    coupled fabric (baseline,   the fabric crashes *inside* the guest:
    wasm)                       any invocation mid-fabric-op dies whole
                                and is re-driven from scratch

Everything here is pure data + interpretation; nothing imports the
executors.

A copy of ``repro.core.faults``, whole. The port has no DES yet, so here
the threaded `FaultInjector` is the only executor a schedule arms; the
schedules themselves (`FaultSchedule.generate`) are the reference's,
field for field, for the same seed and rates.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable

# fault kinds (the closed vocabulary both executors interpret)
BACKEND_CRASH = "backend_crash"    # daemon dies at t (point event)
STORAGE_SLOW = "storage_slow"      # remote-storage tail-latency window
STORAGE_ERROR = "storage_error"    # remote-storage transient-error window
ACK_DROP = "ack_drop"              # writeback acks lost in the window
RESTORE_FAIL = "restore_fail"      # snapshot restores fail once in window
ARENA_EXHAUST = "arena_exhaust"    # arena slots unavailable in the window

KINDS = (BACKEND_CRASH, STORAGE_SLOW, STORAGE_ERROR, ACK_DROP,
         RESTORE_FAIL, ARENA_EXHAUST)

#: fixed redrive overhead charged per retry (control-plane re-issue,
#: idempotency-key lookup) — host-user work in the shared daemon.
RETRY_OVERHEAD_MCYC = 0.05


@dataclass(frozen=True)
class FaultSpec:
    """One fault as pure data.

    ``at_s`` is when the fault begins on the run's fault clock (virtual
    time in the DES, seconds since `FaultInjector.start` threaded);
    ``duration_s`` is the window length (0 for point events like a
    crash); ``factor`` is the `storage_slow` latency multiplier.
    """

    kind: str
    at_s: float
    duration_s: float = 0.0
    factor: float = 8.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.at_s < 0.0:
            raise ValueError("at_s must be >= 0")
        if self.duration_s < 0.0:
            raise ValueError("duration_s must be >= 0")
        if self.kind == STORAGE_SLOW and self.factor <= 1.0:
            raise ValueError("storage_slow factor must be > 1")
        if self.kind != BACKEND_CRASH and self.duration_s == 0.0:
            raise ValueError(f"{self.kind} needs a duration_s window")

    @property
    def end_s(self) -> float:
        return self.at_s + self.duration_s


@dataclass(frozen=True)
class FaultSchedule:
    """A composed, deterministic fault timeline + recovery constants."""

    specs: tuple[FaultSpec, ...] = ()
    restart_delay_s: float = 0.25    # supervisor restart cost after crash
    ack_retry_s: float = 0.2         # writeback-ack redrive timeout
    retry_backoff_s: float = 0.05    # storage-error redrive backoff

    def __post_init__(self):
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"bad schedule entry: {s!r}")
        if self.restart_delay_s <= 0.0:
            raise ValueError("restart_delay_s must be > 0")
        # canonical order: deterministic iteration everywhere
        object.__setattr__(
            self, "specs",
            tuple(sorted(self.specs, key=lambda s: (s.at_s, s.kind,
                                                    s.duration_s))))
        # per-kind window cache: `window_at` sits on both executors'
        # per-op hot paths — no per-query rebuild of the spec scan
        by_kind: dict[str, list] = {}
        for s in self.specs:
            by_kind.setdefault(s.kind, []).append((s.at_s, s.end_s,
                                                   s.factor))
        object.__setattr__(self, "_windows",
                           {k: tuple(v) for k, v in by_kind.items()})

    # -------------------------------------------------------------- queries

    @property
    def is_empty(self) -> bool:
        return not self.specs

    def crashes(self) -> tuple[float, ...]:
        return tuple(w[0] for w in self._windows.get(BACKEND_CRASH, ()))

    def windows(self, kind: str) -> tuple[tuple[float, float, float], ...]:
        """All ``(start, end, factor)`` windows of one kind, sorted
        (precomputed in `__post_init__`)."""
        return self._windows.get(kind, ())

    def window_at(self, kind: str,
                  t: float) -> tuple[float, float, float] | None:
        """The first `kind` window containing `t`, or None."""
        for w in self.windows(kind):
            if w[0] <= t < w[1]:
                return w
        return None

    def horizon(self) -> float:
        """Last instant at which this schedule can still act (crash
        outages included) — benchmarks size their drain tails off it."""
        ts = [0.0]
        for s in self.specs:
            ts.append(s.end_s + (self.restart_delay_s
                                 if s.kind == BACKEND_CRASH else 0.0))
        return max(ts)

    # --------------------------------------------------------- constructors

    @classmethod
    def empty(cls, **kw) -> "FaultSchedule":
        return cls((), **kw)

    @classmethod
    def generate(cls, seed: int, horizon_s: float, *,
                 crash_rate: float = 0.0,
                 storage_slow_rate: float = 0.0,
                 storage_error_rate: float = 0.0,
                 ack_drop_rate: float = 0.0,
                 restore_fail_rate: float = 0.0,
                 arena_exhaust_rate: float = 0.0,
                 mean_window_s: float = 1.0,
                 slow_factor: float = 8.0,
                 **kw) -> "FaultSchedule":
        """Seeded random schedule: each kind is a Poisson process at its
        rate (events/s) over ``[0, horizon_s)``; windowed kinds draw
        exponential window lengths around ``mean_window_s`` (clipped to
        the horizon). Same (seed, params) => same schedule, in any
        process — the chaos harness and the benchmarks rely on it.
        """
        rng = random.Random(seed)
        specs: list[FaultSpec] = []
        for kind, rate in ((BACKEND_CRASH, crash_rate),
                           (STORAGE_SLOW, storage_slow_rate),
                           (STORAGE_ERROR, storage_error_rate),
                           (ACK_DROP, ack_drop_rate),
                           (RESTORE_FAIL, restore_fail_rate),
                           (ARENA_EXHAUST, arena_exhaust_rate)):
            if rate <= 0.0:
                continue
            t = rng.expovariate(rate)
            while t < horizon_s:
                if kind == BACKEND_CRASH:
                    dur = 0.0
                else:
                    dur = min(max(rng.expovariate(1.0 / mean_window_s),
                                  1e-3),
                              horizon_s - t)
                specs.append(FaultSpec(kind, t, dur, slow_factor))
                t += rng.expovariate(rate)
        return cls(tuple(specs), **kw)

    def scaled(self, time_scale: float) -> "FaultSchedule":
        """The same schedule with every time stretched by `time_scale`
        (the threaded runtime replays DES-scale schedules slower)."""
        return replace(
            self,
            specs=tuple(replace(s, at_s=s.at_s * time_scale,
                                duration_s=s.duration_s * time_scale)
                        for s in self.specs),
            restart_delay_s=self.restart_delay_s * time_scale,
            ack_retry_s=self.ack_retry_s * time_scale,
            retry_backoff_s=self.retry_backoff_s * time_scale)


# ------------------------------------------------------------ threaded side

@dataclass
class FaultHooks:
    """Mutable fault taps one `runtime.WorkerNode` owns.

    Components read these *at call time* (not at construction), so a
    backend recreated by the supervisor after a crash stays armed, and
    disarming is one attribute store. ``None`` means: no fault.
    """

    #: ack_drop(dedup_key) -> True to lose this durable write's ack
    ack_drop: Callable[[str], bool] | None = None
    #: restore_fail() -> True to fail the current restore attempt
    restore_fail: Callable[[], bool] | None = None
    #: guest_crash() -> True while the in-guest fabric is crashed
    #: (coupled variants only: kills the whole invocation)
    guest_crash: Callable[[], bool] | None = None


class FaultInjector:
    """Arm one threaded `WorkerNode` with a `FaultSchedule` in real time.

    The injector drives the schedule through the runtime's existing
    seams only — it adds no execution paths of its own:

    * `backend_crash`  -> `Supervisor.kill_backend()` at ``at_s``
      (offloaded variants); coupled variants see the same instants as
      `FaultHooks.guest_crash` windows of width ``restart_delay_s``;
    * `storage_slow` / `storage_error` -> window fields of the
      `storage.FaultPlan` already consulted by `RemoteStorage`;
    * `ack_drop` -> `FaultHooks.ack_drop`, dropping each logical
      write's ack at most once (the redrive must find the idempotency
      record, not a second drop);
    * `restore_fail` -> `FaultHooks.restore_fail`;
    * `arena_exhaust` -> hog slots allocated from every deployed
      tenant's arena for the window (reclaim is a real `Slot.release`).

    Use as a context manager; `now()` is the shared fault clock.
    """

    def __init__(self, node, schedule: FaultSchedule, *,
                 arena_hog_fraction: float = 0.97):
        self.node = node
        self.schedule = schedule
        self.arena_hog_fraction = arena_hog_fraction
        self._t0: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._saved_faults = None
        self._saved_restart = None
        self._dropped: set[str] = set()
        self._drop_lock = threading.Lock()
        self._hogs: dict[int, list] = {}
        self.stats = {"crashes": 0, "acks_dropped": 0,
                      "restores_failed": 0, "arena_hogs": 0}

    # ------------------------------------------------------------- clock

    def now(self) -> float:
        assert self._t0 is not None, "injector not started"
        return time.monotonic() - self._t0

    # ------------------------------------------------------------- hooks

    def _ack_drop(self, dedup_key: str) -> bool:
        if self.schedule.window_at(ACK_DROP, self.now()) is None:
            return False
        with self._drop_lock:
            if dedup_key in self._dropped:
                return False            # redrives must resolve
            self._dropped.add(dedup_key)
        self.stats["acks_dropped"] += 1
        return True

    def _restore_fail(self) -> bool:
        if self.schedule.window_at(RESTORE_FAIL, self.now()) is None:
            return False
        self.stats["restores_failed"] += 1
        return True

    def _guest_crash(self) -> bool:
        t = self.now()
        return any(at <= t < at + self.schedule.restart_delay_s
                   for at in self.schedule.crashes())

    def _kill_backend(self) -> None:
        # count the kills THIS injector drove (the supervisor's restart
        # counter is lifetime-per-node and lags the swap)
        self.stats["crashes"] += 1
        guard = getattr(self.node, "guard", None)
        if guard is not None and guard.breaker is not None:
            guard.breaker.on_crash()    # GuardRails: open on crash signal
        self.node.supervisor.kill_backend()

    # ------------------------------------------------------------ arming

    def start(self) -> "FaultInjector":
        from repro_torch.core.storage import FaultPlan
        sched, node = self.schedule, self.node
        self._t0 = time.monotonic()
        self._stop.clear()
        self._saved_faults = node.remote.faults
        node.remote.faults = FaultPlan(
            slow_windows=sched.windows(STORAGE_SLOW),
            fail_windows=sched.windows(STORAGE_ERROR),
            clock=self.now)
        hooks: FaultHooks = node.fault_hooks
        hooks.ack_drop = self._ack_drop
        hooks.restore_fail = self._restore_fail
        if node.spec.coupled:
            hooks.guest_crash = self._guest_crash
        if node.supervisor is not None:
            self._saved_restart = node.supervisor.restart_delay_s
            node.supervisor.restart_delay_s = sched.restart_delay_s
        guard = getattr(node, "guard", None)
        if (guard is not None and guard.breaker is not None
                and guard.policy.breaker.open_on_slow):
            # brown-out shedding: the breaker reads the schedule's slow
            # windows on the injector's fault clock (t=0 at start()),
            # NOT the node's uptime clock
            guard.breaker.set_slow_windows(sched.windows(STORAGE_SLOW),
                                           clock=self.now)

        events: list[tuple[float, Callable[[], None]]] = []
        if node.supervisor is not None:
            for at in sched.crashes():
                events.append((at, self._kill_backend))
        for i, (at, end, _f) in enumerate(sched.windows(ARENA_EXHAUST)):
            events.append((at, lambda i=i: self._hog_arenas(i)))
            events.append((end, lambda i=i: self._unhog_arenas(i)))
        events.sort(key=lambda e: e[0])
        if events:
            self._thread = threading.Thread(
                target=self._drive, args=(events,), daemon=True,
                name="fault-injector")
            self._thread.start()
        return self

    def _drive(self, events) -> None:
        for at, fire in events:
            delay = at - self.now()
            if delay > 0 and self._stop.wait(delay):
                break
            try:
                fire()
            except Exception:               # noqa: BLE001 — chaos driver
                pass

    def _hog_arenas(self, i: int) -> None:
        arenas = getattr(self.node, "_arenas", None)
        if arenas is None:
            return
        hogs = self._hogs.setdefault(i, [])
        for tenant in list(self.node._pools):
            try:
                arena = arenas.get(tenant)
                free = int((arena.capacity - arena.allocated)
                           * self.arena_hog_fraction)
                if free > 0:
                    hogs.append(arena.alloc(free))
                    self.stats["arena_hogs"] += 1
            except Exception:               # noqa: BLE001 — best effort
                pass

    def _unhog_arenas(self, i: int) -> None:
        for slot in self._hogs.pop(i, []):
            slot.release()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for i in list(self._hogs):
            self._unhog_arenas(i)
        node = self.node
        if self._saved_faults is not None:
            node.remote.faults = self._saved_faults
        if self._saved_restart is not None and node.supervisor is not None:
            node.supervisor.restart_delay_s = self._saved_restart
        hooks: FaultHooks = node.fault_hooks
        hooks.ack_drop = hooks.restore_fail = hooks.guest_crash = None
        guard = getattr(node, "guard", None)
        if guard is not None and guard.breaker is not None:
            guard.breaker.set_slow_windows(())   # disarm brown-out windows

    def __enter__(self) -> "FaultInjector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
