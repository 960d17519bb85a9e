"""GuardRails: overload control as one policy plane.

The shared always-on backend is the density win *and* the common
failure domain: past the knee, or mid-fault-recovery, every tenant on
the node degrades together — and the paper never measures past the
knee. This module is the node's defense, expressed the way
`plan.SystemSpec` and `faults.FaultSchedule` express structure: a
`GuardrailPolicy` is pure data, and BOTH executors interpret the same
object —

* the threaded `runtime.WorkerNode` enforces it with real clocks and
  threads (`invoke` sheds with typed `Rejected`, `drain()` quiesces,
  the `NexusClient` retry loops draw from the bounded `RetrySpec`
  budget, the `CircuitBreaker` watches the live backend);
* `des.DensitySimulator(guardrails=...)` models it in virtual time
  (shed/queue events at `_arrive`, goodput and SLO-violation counters
  in `SimResult`), so predicted shed counts are differential-testable
  against the threaded node's measured ones.

The policy bundles five controls:

admission   per-tenant token bucket (invocations/s + burst) — finally
            wiring `core/ratelimit.py` into the real data path — with
            SLO-class priorities: priority-0 (best-effort) classes shed
            the moment the bucket empties, higher classes may queue up
            to ``max_queue_s`` of pacing delay;
deadlines   per-class ``deadline_factor`` × the variant's unloaded
            latency; a queued request that can no longer make its
            deadline is shed *at admission* (deadline propagation), a
            completed one past it counts as an SLO violation;
retry       bounded attempts with exponential backoff + deterministic
            jitter (`backoff_delays`) replacing fixed-sleep loops;
breaker     circuit breaker over the shared backend: opens on crash
            signals (`on_crash`) or a failure burst from the data path,
            optionally on scheduled slow windows; half-open probes;
drain       quiesce windows (stop admitting, finish in-flight, flush
            write chains, hand off) — `drains_for` derives them from a
            `FaultSchedule`'s crash instants, so planned restarts ride
            the existing fault machinery.

Everything here is pure data + a small deterministic state machine
(`GuardState`); nothing imports the executors. An empty policy decides
"admit" for every request and perturbs neither executor (the DES golden
gate pins this bit-for-bit).

A copy of ``repro.core.guardrails`` without ``GuardrailPolicy.scaled``,
which stretches a policy for replays of the density simulator's
schedules (the port has no density simulator yet). The worker node calls
`GuardState.decide` on every invocation, `NexusClient` retries through
`RetrySpec`, and `drains_for` derives drain windows from a
`faults.FaultSchedule`.
"""
from __future__ import annotations

import threading
import zlib
from collections import deque
from dataclasses import dataclass

from repro_torch.core.ratelimit import TokenBucket

__all__ = [
    "SHED_REASONS", "Rejected", "DeadlineExceeded", "GuardrailRejection",
    "SloClass", "AdmissionSpec", "RetrySpec", "BreakerSpec", "DrainWindow",
    "GuardrailPolicy", "Decision", "CircuitBreaker", "GuardState",
    "backoff_delays",
]

#: the closed vocabulary of shed causes (SimResult.shed / GuardState.shed
#: key space — both executors count into the same buckets)
SHED_REASONS = ("admission", "queue_full", "deadline", "breaker", "drain")


# ----------------------------------------------------------- typed responses

class GuardrailRejection(RuntimeError):
    """Base of the two client-visible guardrail outcomes. Carries the
    shed reason and (when known) how long the caller should back off
    before re-driving."""

    def __init__(self, reason: str, *, retry_after_s: float = 0.0,
                 result=None):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s
        #: for post-completion deadline misses: the full
        #: `InvocationResult` (the work WAS done durably — at-least-once
        #: is unaffected; only the response is typed as late)
        self.result = result


class Rejected(GuardrailRejection):
    """Shed before any work started: atomically — zero partial PUTs,
    no instance acquired, no bytes moved."""


class DeadlineExceeded(GuardrailRejection):
    """The request cannot (admission-time propagation) or did not
    (completion-time check) make its deadline."""


# ------------------------------------------------------------- policy data

@dataclass(frozen=True)
class SloClass:
    """One service class: a priority and an optional deadline.

    ``priority`` 0 is best-effort (shed immediately when the admission
    bucket empties, never queued); >= 1 may queue. ``deadline_factor``
    is multiplied by the variant's unloaded latency — the same
    normalization as the paper's p99 < 5x SLO."""

    name: str
    priority: int = 1
    deadline_factor: float | None = None

    def __post_init__(self):
        if self.priority < 0:
            raise ValueError("priority must be >= 0")
        if self.deadline_factor is not None and self.deadline_factor <= 1.0:
            raise ValueError("deadline_factor must be > 1")


@dataclass(frozen=True)
class AdmissionSpec:
    """Per-tenant token-bucket admission: `rate_per_s` invocations/s
    refill with `burst` capacity; a queued request waits at most
    ``max_queue_s`` of bucket pacing delay before it is shed."""

    rate_per_s: float
    burst: float
    max_queue_s: float = 0.0

    def __post_init__(self):
        if self.rate_per_s <= 0.0:
            raise ValueError("rate_per_s must be > 0")
        if self.burst < 1.0:
            raise ValueError("burst must be >= 1 invocation")
        if self.max_queue_s < 0.0:
            raise ValueError("max_queue_s must be >= 0")


@dataclass(frozen=True)
class RetrySpec:
    """A bounded retry budget: at most ``max_attempts`` tries, backoff
    ``base * factor**i`` capped at ``max_backoff_s``, stretched by up
    to ``jitter_frac`` of *deterministic* jitter (crc32 of the retry
    key — reproducible, yet decorrelated across invocations)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.002
    backoff_factor: float = 2.0
    jitter_frac: float = 0.1
    max_backoff_s: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s < 0.0 or self.max_backoff_s < 0.0:
            raise ValueError("backoff times must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError("jitter_frac must be in [0, 1]")


def backoff_delays(spec: RetrySpec, key: str = "") -> tuple[float, ...]:
    """The full deterministic backoff schedule for one retry key: one
    delay per allowed attempt. Same (spec, key) => same delays, in any
    process — the differential harness depends on it."""
    out = []
    d = spec.backoff_base_s
    for i in range(spec.max_attempts):
        u = (zlib.crc32(f"{key}:{i}".encode()) & 0xFFFFFFFF) / 2.0 ** 32
        out.append(min(d * (1.0 + spec.jitter_frac * u), spec.max_backoff_s))
        d *= spec.backoff_factor
    return tuple(out)


@dataclass(frozen=True)
class BreakerSpec:
    """Circuit breaker over the shared backend: opens for ``open_s``
    after a crash signal or ``failure_threshold`` data-path failures
    inside ``window_s``; then admits ``half_open_probes`` probes before
    closing (a failure during half-open re-opens). With
    ``open_on_slow`` the breaker also treats scheduled `storage_slow`
    windows as open (brown-out shedding)."""

    failure_threshold: int = 3
    window_s: float = 1.0
    open_s: float = 0.5
    half_open_probes: int = 1
    open_on_slow: bool = False

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.window_s <= 0.0 or self.open_s <= 0.0:
            raise ValueError("window_s and open_s must be > 0")
        if self.half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")


@dataclass(frozen=True)
class DrainWindow:
    """One quiesce window: admission closed on [at_s, at_s+duration_s)."""

    at_s: float
    duration_s: float

    def __post_init__(self):
        if self.at_s < 0.0:
            raise ValueError("at_s must be >= 0")
        if self.duration_s <= 0.0:
            raise ValueError("duration_s must be > 0")

    @property
    def end_s(self) -> float:
        return self.at_s + self.duration_s


@dataclass(frozen=True)
class GuardrailPolicy:
    """The whole policy plane as one immutable value.

    Every field defaults to "off"; `GuardrailPolicy()` (== `disabled()`)
    admits everything and is guaranteed not to perturb either executor.
    ``classes``/``class_map`` assign workload base names to `SloClass`es
    (``default_class`` catches the rest); ``deadline_factor`` is the
    fallback deadline for functions whose class declares none.
    """

    admission: AdmissionSpec | None = None
    classes: tuple[SloClass, ...] = ()
    class_map: tuple[tuple[str, str], ...] = ()   # (base name, class name)
    default_class: str | None = None
    deadline_factor: float | None = None
    retry: RetrySpec | None = None
    breaker: BreakerSpec | None = None
    drains: tuple[DrainWindow, ...] = ()

    def __post_init__(self):
        by_name = {}
        for c in self.classes:
            if not isinstance(c, SloClass):
                raise TypeError(f"bad class entry: {c!r}")
            if c.name in by_name:
                raise ValueError(f"duplicate class {c.name!r}")
            by_name[c.name] = c
        cmap = {}
        for base, cname in self.class_map:
            if cname not in by_name:
                raise ValueError(f"class_map -> unknown class {cname!r}")
            cmap[base] = by_name[cname]
        if self.default_class is not None \
                and self.default_class not in by_name:
            raise ValueError(f"unknown default_class "
                             f"{self.default_class!r}")
        if self.deadline_factor is not None and self.deadline_factor <= 1.0:
            raise ValueError("deadline_factor must be > 1")
        for d in self.drains:
            if not isinstance(d, DrainWindow):
                raise TypeError(f"bad drain entry: {d!r}")
        object.__setattr__(self, "drains",
                           tuple(sorted(self.drains,
                                        key=lambda d: d.at_s)))
        object.__setattr__(self, "_by_name", by_name)
        object.__setattr__(self, "_cmap", cmap)

    # ------------------------------------------------------------ queries

    @property
    def is_empty(self) -> bool:
        """No control configured — every decision is "admit"."""
        return (self.admission is None and self.breaker is None
                and not self.drains and self.deadline_factor is None
                and not self.classes and self.retry is None)

    def class_of(self, base_name: str) -> SloClass | None:
        cls = self._cmap.get(base_name)
        if cls is None and self.default_class is not None:
            cls = self._by_name[self.default_class]
        return cls

    def drain_at(self, t: float) -> DrainWindow | None:
        for d in self.drains:
            if d.at_s <= t < d.end_s:
                return d
        return None

    # ------------------------------------------------------- constructors

    @classmethod
    def disabled(cls) -> "GuardrailPolicy":
        return cls()

    @classmethod
    def drains_for(cls, schedule, *, lead_s: float = 0.2,
                   settle_s: float = 0.2) -> tuple[DrainWindow, ...]:
        """Quiesce windows bracketing each scheduled crash/restart in a
        `faults.FaultSchedule`: stop admitting ``lead_s`` before the
        kill, stay closed through the restart plus ``settle_s`` — the
        planned-restart story rides the existing fault machinery."""
        return tuple(
            DrainWindow(max(0.0, at - lead_s),
                        (at - max(0.0, at - lead_s))
                        + schedule.restart_delay_s + settle_s)
            for at in schedule.crashes())


# ----------------------------------------------------------- interpretation

@dataclass(frozen=True)
class Decision:
    """One admission verdict. ``delay_s`` is the bucket pacing delay
    for "queue" (dispatch at now+delay) and the suggested retry-after
    for "shed"."""

    action: str                 # "admit" | "queue" | "shed"
    delay_s: float = 0.0
    reason: str | None = None


_ADMIT = Decision("admit")


class CircuitBreaker:
    """Deterministic breaker state machine over an injectable clock.

    Inputs: ``on_crash()`` (a crash signal — the DES's scheduled crash
    events, or `Supervisor.kill_backend` threaded), ``record_failure``/
    ``record_success`` from the data path (`NexusClient` retry loop),
    and optional scheduled slow windows. ``allows()`` is the one gate
    admission consults."""

    def __init__(self, spec: BreakerSpec, clock):
        self.spec = spec
        self._clock = clock
        self._lock = threading.Lock()
        self._failures: deque = deque()
        self._state = "closed"
        self._open_until = 0.0
        self._probes = 0
        self._slow: tuple = ()
        self._slow_clock = None
        self.opens = 0

    def set_slow_windows(self, windows, clock=None) -> None:
        """Arm scheduled ``(start, end, ...)`` slow windows (only
        consulted with ``open_on_slow``). `clock` overrides the window
        time base — the threaded FaultInjector's windows run on ITS
        fault clock, not the node's uptime clock."""
        with self._lock:
            self._slow = tuple(windows)
            self._slow_clock = clock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def on_crash(self) -> None:
        with self._lock:
            self._open(self._clock())

    def _open(self, now: float) -> None:
        self._state = "open"
        self._open_until = now + self.spec.open_s
        self._failures.clear()
        self.opens += 1

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            if self._state == "half_open":
                self._open(now)             # probe failed: re-open
                return
            f = self._failures
            f.append(now)
            while f and f[0] < now - self.spec.window_s:
                f.popleft()
            if len(f) >= self.spec.failure_threshold:
                self._open(now)

    def record_success(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._state = "closed"
                self._failures.clear()

    def allows(self) -> bool:
        with self._lock:
            now = self._clock()
            if self.spec.open_on_slow and self._slow:
                t = now if self._slow_clock is None else self._slow_clock()
                for w in self._slow:
                    if w[0] <= t < w[1]:
                        return False
            if self._state == "open":
                if now < self._open_until:
                    return False
                self._state = "half_open"
                self._probes = self.spec.half_open_probes
            if self._state == "half_open":
                if self._probes <= 0:
                    return False
                self._probes -= 1
                if self._probes == 0:
                    # optimistic close once the probe budget is spent;
                    # any failure signal re-opens immediately
                    self._state = "closed"
            return True


class GuardState:
    """One policy interpreted over one clock — the single decision
    machine both executors drive (virtual ``loop.now`` in the DES, a
    monotonic uptime clock threaded). Deterministic: decisions are a
    pure function of the (policy, clock-at-arrival) sequence, which is
    what lets the DES *predict* the threaded node's shed counts."""

    def __init__(self, policy: GuardrailPolicy, clock):
        self.policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        self.breaker = (CircuitBreaker(policy.breaker, clock)
                        if policy.breaker is not None else None)
        self._buckets: dict[str, TokenBucket] = {}
        self._draining = False
        self.admitted = 0
        self.queued = 0
        self.slo_violations = 0
        self.shed = {r: 0 for r in SHED_REASONS}

    # ------------------------------------------------------------- drain

    def begin_drain(self) -> None:
        """Explicit quiesce overlay (in addition to scheduled windows)."""
        with self._lock:
            self._draining = True

    def end_drain(self) -> None:
        with self._lock:
            self._draining = False

    @property
    def draining(self) -> bool:
        pol = self.policy
        return self._draining or (bool(pol.drains)
                                  and pol.drain_at(self._clock())
                                  is not None)

    # --------------------------------------------------------- admission

    def _bucket(self, tenant: str) -> TokenBucket:
        adm = self.policy.admission
        b = self._buckets.get(tenant)
        if b is None:
            b = TokenBucket(adm.rate_per_s, adm.burst, clock=self._clock)
            self._buckets[tenant] = b
        return b

    def _shed(self, reason: str, retry_after: float = 0.0) -> Decision:
        self.shed[reason] += 1
        return Decision("shed", retry_after, reason)

    def decide(self, tenant: str, base_name: str,
               unloaded_s: float | None = None) -> Decision:
        """The admission verdict for one arrival. Checked in order:
        drain -> breaker -> token bucket (+ class priority + deadline
        propagation). Shed checks run BEFORE the bucket is debited, and
        a debit that ends in a shed is cancelled (`Reservation`), so a
        rejected arrival never burns budget."""
        with self._lock:
            now = self._clock()
            pol = self.policy
            if self._draining:
                return self._shed("drain")
            if pol.drains:
                d = pol.drain_at(now)
                if d is not None:
                    return self._shed("drain", d.end_s - now)
            br = self.breaker
            if br is not None and not br.allows():
                return self._shed("breaker", pol.breaker.open_s)
            adm = pol.admission
            if adm is None:
                self.admitted += 1
                return _ADMIT
            res = self._bucket(tenant).reserve_tx(1)
            if res.delay <= 0.0:
                self.admitted += 1
                return _ADMIT
            cls = pol.class_of(base_name)
            prio = 1 if cls is None else cls.priority
            if prio <= 0:
                res.cancel()
                return self._shed("admission", res.delay)
            if res.delay > adm.max_queue_s:
                res.cancel()
                return self._shed("queue_full", res.delay)
            dl = self.deadline_for(base_name, unloaded_s)
            if (dl is not None and unloaded_s is not None
                    and res.delay + unloaded_s > dl):
                # deadline propagation: the request can no longer make
                # its deadline even unloaded — shed now, waste nothing
                res.cancel()
                return self._shed("deadline", res.delay)
            self.queued += 1
            return Decision("queue", res.delay)

    def note_violation(self) -> None:
        """Count one completed-past-deadline response (the executor
        calls this where it measures the latency)."""
        with self._lock:
            self.slo_violations += 1

    # ---------------------------------------------------------- deadlines

    def deadline_for(self, base_name: str,
                     unloaded_s: float | None) -> float | None:
        """Absolute end-to-end deadline (seconds) for one function, or
        None when neither its class nor the policy sets one."""
        if unloaded_s is None:
            return None
        cls = self.policy.class_of(base_name)
        f = (cls.deadline_factor if cls is not None
             and cls.deadline_factor is not None
             else self.policy.deadline_factor)
        return None if f is None else f * unloaded_s

    # ------------------------------------------------------------ reports

    @property
    def total_shed(self) -> int:
        return sum(self.shed.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {"admitted": self.admitted, "queued": self.queued,
                    "shed": dict(self.shed),
                    "slo_violations": self.slo_violations,
                    "draining": self._draining,
                    "breaker": None if self.breaker is None
                    else self.breaker.state}
