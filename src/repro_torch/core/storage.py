"""Remote object storage (MinIO-stand-in) + transport-modeled access.

`ObjectStore` is the cluster's remote storage service: a thread-safe
versioned KV of real bytes (the paper's 4 dedicated MinIO nodes — never
the bottleneck, so service time is bandwidth + base latency only).

`RemoteStorage` is what a worker-side fabric talks to: it applies the
chosen transport's latency (really slept) and cycle costs (accounted),
plus optional hedged reads for straggler mitigation — a second request
is issued if the first exceeds the hedge threshold, first response wins
(framework-scale fault-tolerance feature; off in paper-faithful runs).

A copy of ``repro.core.storage``, whole: the worker node always
passes its ``faults=`` plan through to `RemoteStorage`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from repro_torch.core import metrics as M
from repro_torch.core.transport import TransportSpec, TRANSPORTS

MB = 1024 * 1024


class StorageError(KeyError):
    pass


@dataclass
class ObjectMeta:
    size: int
    etag: int          # version counter


class ObjectStore:
    """The remote, shared object store (lives off the worker node)."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._meta: dict[str, ObjectMeta] = {}
        self._lock = threading.RLock()
        self.gets = 0
        self.puts = 0

    @staticmethod
    def _key(bucket: str, key: str) -> str:
        return f"{bucket}/{key}"

    def put(self, bucket: str, key: str, data: bytes) -> ObjectMeta:
        k = self._key(bucket, key)
        with self._lock:
            etag = self._meta[k].etag + 1 if k in self._meta else 1
            self._data[k] = bytes(data)
            self._meta[k] = ObjectMeta(len(data), etag)
            self.puts += 1
            return self._meta[k]

    def get(self, bucket: str, key: str) -> bytes:
        return self.get_with_meta(bucket, key)[0]

    def get_with_meta(self, bucket: str, key: str) -> tuple[bytes, ObjectMeta]:
        """Bytes + metadata captured under ONE lock hold, so the
        returned etag is the version of exactly these bytes. Cache
        fills must bind payload and etag from this atomic snapshot — a
        separate head() after the get leaves the whole modeled transfer
        as a window for a concurrent PUT to bump the etag, silently
        stamping new-version metadata onto old-version bytes."""
        k = self._key(bucket, key)
        with self._lock:
            if k not in self._data:
                raise StorageError(f"NoSuchKey: {k}")
            self.gets += 1
            return self._data[k], self._meta[k]

    def head(self, bucket: str, key: str) -> ObjectMeta:
        k = self._key(bucket, key)
        with self._lock:
            if k not in self._meta:
                raise StorageError(f"NoSuchKey: {k}")
            return self._meta[k]

    def delete(self, bucket: str, key: str) -> None:
        k = self._key(bucket, key)
        with self._lock:
            self._data.pop(k, None)
            self._meta.pop(k, None)

    def list_bucket(self, bucket: str) -> dict[str, bytes]:
        """Snapshot of one bucket's durable state: key -> bytes. The
        chaos harness diffs these byte-for-byte against the fault-free
        oracle's."""
        prefix = bucket + "/"
        with self._lock:
            # bytes(v) on a bytes object returns v itself — a live
            # reference into the store, not a snapshot. Route through
            # memoryview to force a genuine copy.
            return {k[len(prefix):]: bytes(memoryview(v))
                    for k, v in self._data.items() if k.startswith(prefix)}


@dataclass
class FaultPlan:
    """Deterministic fault injection for resilience tests/benchmarks.

    Two modes, composable:

    * counter-based (`slow_every` / `fail_every`): every Nth op is a
      straggler / transient error — load-independent, the historical
      hedged-read test harness;
    * window-based (`slow_windows` / `fail_windows` + `clock`): the
      `faults.FaultSchedule` storage windows, evaluated against the
      shared fault clock — what `faults.FaultInjector` arms. A window
      is ``(start_s, end_s, factor)``; ops started inside a slow
      window stretch by ``factor``, ops inside a fail window raise a
      transient `ConnectionError` (frontends retry).
    """

    slow_every: int = 0            # every Nth op is a straggler
    slow_factor: float = 8.0
    fail_every: int = 0            # every Nth op raises (transient)
    slow_windows: tuple = ()       # (start_s, end_s, factor) on `clock`
    fail_windows: tuple = ()       # (start_s, end_s, _) on `clock`
    clock: object = None           # callable -> seconds on the fault clock

    def slow_factor_at(self, t: float) -> float:
        for s, e, f in self.slow_windows:
            if s <= t < e:
                return f
        return 1.0

    def failing_at(self, t: float) -> bool:
        return any(s <= t < e for s, e, _f in self.fail_windows)


class RemoteStorage:
    """Worker-side access path to the store over a modeled transport."""

    def __init__(self, store: ObjectStore, transport: TransportSpec | str,
                 acct: M.CycleAccount, *, hedge_after_s: float | None = None,
                 faults: FaultPlan | None = None, sleep=time.sleep,
                 cost_scale: float = 1.0):
        self.store = store
        self.transport = (TRANSPORTS[transport]
                          if isinstance(transport, str) else transport)
        self.acct = acct
        # benchmarks shrink REAL payload bytes (hash cost) by byte_scale;
        # cost_scale (= 1/byte_scale) restores NOMINAL sizes for every
        # latency/cycle/crossing model so the physics stay full-size.
        self.cost_scale = cost_scale
        self.hedge_after_s = hedge_after_s
        self.faults = faults or FaultPlan()
        self._sleep = sleep
        self._op_counter = 0
        self._lock = threading.Lock()
        self.hedges_fired = 0
        self.transient_failures = 0

    def _next_op(self) -> int:
        with self._lock:
            self._op_counter += 1
            return self._op_counter

    def _service_time(self, nbytes: int, op_no: int) -> float:
        t = self.transport.transfer_latency(int(nbytes * self.cost_scale))
        f = self.faults
        if f.slow_every and op_no % f.slow_every == 0:
            t *= f.slow_factor
        if f.slow_windows and f.clock is not None:
            t *= f.slow_factor_at(f.clock())
        return t

    def _maybe_fail(self, op_no: int) -> None:
        f = self.faults
        if f.fail_every and op_no % f.fail_every == 0:
            self.transient_failures += 1
            raise ConnectionError(f"transient storage failure (op {op_no})")
        if f.fail_windows and f.clock is not None and f.failing_at(f.clock()):
            self.transient_failures += 1
            raise ConnectionError(
                f"transient storage failure (fault window, op {op_no})")

    def get(self, bucket: str, key: str) -> bytes:
        return self.get_with_meta(bucket, key)[0]

    def get_with_meta(self, bucket: str, key: str) -> tuple[bytes, ObjectMeta]:
        """GET returning the store's atomic (bytes, meta) snapshot —
        the etag a cache fill may bind to these bytes. The snapshot is
        taken before the modeled transfer sleep, so a PUT committing
        mid-transfer cannot pair its etag with our older payload."""
        op = self._next_op()
        self._maybe_fail(op)
        data, meta = self.store.get_with_meta(bucket, key)
        t = self._service_time(len(data), op)
        if self.hedge_after_s is not None and t > self.hedge_after_s:
            # hedged read: fire a duplicate request; it completes at the
            # un-slowed service time, and the first response wins.
            self.hedges_fired += 1
            t = min(t, self.hedge_after_s
                    + self.transport.transfer_latency(
                        int(len(data) * self.cost_scale)))
        self._sleep(t)
        self.transport.charge_transfer(self.acct,
                                       int(len(data) * self.cost_scale))
        return data, meta

    def put(self, bucket: str, key: str, data) -> ObjectMeta:
        op = self._next_op()
        self._maybe_fail(op)
        nbytes = len(data)
        self._sleep(self._service_time(nbytes, op))
        self.transport.charge_transfer(self.acct,
                                       int(nbytes * self.cost_scale))
        return self.store.put(bucket, key, bytes(data))

    def head(self, bucket: str, key: str) -> ObjectMeta:
        self._sleep(self.transport.base_latency_s)
        return self.store.head(bucket, key)
