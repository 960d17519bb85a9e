"""Per-SDK-client token-bucket rate limiting (paper §4.4).

Mirrors the baseline's per-virtio-thread fixed transmission rate
(600 Mbps-class, as on AWS Lambda) inside the Nexus backend, via the
same semantics as golang.org/x/time/rate: a bucket refilled at `rate`
bytes/s with `burst` capacity; `reserve(n)` returns the delay the caller
must wait before the transfer may proceed. If a function holds several
SDK clients, its budget is divided equally among them (§4.4).

Two hardening properties (the GuardRails admission plane leans on
both):

* `reserve_tx` returns a `Reservation` whose ``cancel()`` refunds the
  debit — an aborted transfer (a shed arrival, a faulted retry that
  re-submits through a fresh path) must not double-debit the budget;
* negative-token debt is clamped at ``max_debt_s`` seconds of refill,
  so a burst of oversized reservations cannot push the bucket into
  unbounded debt that starves the tenant long after the burst passed.
"""
from __future__ import annotations

import threading
import time

MBPS = 1024 * 1024 / 8          # bytes/s per Mbit/s
DEFAULT_RATE_MBPS = 600.0

#: default cap on accumulated debt, in seconds of refill: no single
#: burst may delay later traffic by more than this
DEFAULT_MAX_DEBT_S = 60.0


class Reservation:
    """One granted debit. ``delay`` is the seconds the caller must wait
    before proceeding; ``cancel()`` returns the tokens (idempotent) if
    the transfer is aborted instead."""

    __slots__ = ("_bucket", "amount", "delay", "_cancelled")

    def __init__(self, bucket: "TokenBucket", amount: float, delay: float):
        self._bucket = bucket
        self.amount = amount
        self.delay = delay
        self._cancelled = False

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> None:
        if self._cancelled:
            return
        self._cancelled = True
        b = self._bucket
        with b._lock:
            b._tokens = min(b.burst, b._tokens + self.amount)


class TokenBucket:
    def __init__(self, rate_bps: float, burst_bytes: float | None = None,
                 clock=time.monotonic,
                 max_debt_s: float = DEFAULT_MAX_DEBT_S):
        self.rate = float(rate_bps)
        self.burst = float(burst_bytes if burst_bytes is not None
                           else rate_bps * 0.25)      # 250 ms of burst
        self.max_debt_s = float(max_debt_s)
        self._tokens = self.burst
        self._last = clock()
        self._clock = clock
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def reserve_tx(self, nbytes: float) -> Reservation:
        """Debit `nbytes` and return the cancellable `Reservation`.
        Debt is clamped at ``max_debt_s * rate`` tokens — the delay a
        reservation can observe (or impose on later ones) is bounded."""
        with self._lock:
            now = self._clock()
            self._refill(now)
            self._tokens -= nbytes
            floor = -self.max_debt_s * self.rate
            if self._tokens < floor:
                self._tokens = floor
            delay = 0.0 if self._tokens >= 0 else -self._tokens / self.rate
        return Reservation(self, nbytes, delay)

    def reserve(self, nbytes: float) -> float:
        """Debit `nbytes`; return seconds the caller must delay (>= 0)."""
        return self.reserve_tx(nbytes).delay

    def throttle(self, nbytes: int, sleep=time.sleep) -> float:
        d = self.reserve(nbytes)
        if d > 0:
            sleep(d)
        return d


class ClientLimiter:
    """Per-function budget split across its SDK clients (§4.4)."""

    def __init__(self, total_rate_mbps: float = DEFAULT_RATE_MBPS):
        self._total = total_rate_mbps * MBPS
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def bucket(self, client: str) -> TokenBucket:
        with self._lock:
            if client not in self._buckets:
                self._buckets[client] = TokenBucket(1.0)   # placeholder rate
                per = self._total / len(self._buckets)
                for b in self._buckets.values():
                    b.rate = per
                    b.burst = per * 0.25
            return self._buckets[client]
