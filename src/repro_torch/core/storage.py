"""Remote object storage (MinIO-stand-in) + transport-modeled access.

`ObjectStore` is the cluster's remote storage service: a thread-safe
versioned KV of real bytes (the paper's 4 dedicated MinIO nodes — never
the bottleneck, so service time is bandwidth + base latency only).

`RemoteStorage` is what a worker-side fabric talks to: it applies the
chosen transport's latency (really slept) and cycle costs (accounted),
plus optional hedged reads for straggler mitigation — a second request
is issued if the first exceeds the hedge threshold, first response wins
(framework-scale fault-tolerance feature; off in paper-faithful runs).

A copy of ``repro.core.storage`` for the port's serve driver, without
the fault-injection plan (``FaultPlan``), which that driver never arms.
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


class RemoteStorage:
    """Worker-side access path to the store over a modeled transport."""

    def __init__(self, store: ObjectStore, transport: TransportSpec | str,
                 acct: M.CycleAccount, *, hedge_after_s: float | None = None,
                 sleep=time.sleep,
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
        self._sleep = sleep
        self.hedges_fired = 0

    def _service_time(self, nbytes: int) -> float:
        return self.transport.transfer_latency(int(nbytes * self.cost_scale))

    def get(self, bucket: str, key: str) -> bytes:
        return self.get_with_meta(bucket, key)[0]

    def get_with_meta(self, bucket: str, key: str) -> tuple[bytes, ObjectMeta]:
        """GET returning the store's atomic (bytes, meta) snapshot —
        the etag a cache fill may bind to these bytes. The snapshot is
        taken before the modeled transfer sleep, so a PUT committing
        mid-transfer cannot pair its etag with our older payload."""
        data, meta = self.store.get_with_meta(bucket, key)
        t = self._service_time(len(data))
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
        nbytes = len(data)
        self._sleep(self._service_time(nbytes))
        self.transport.charge_transfer(self.acct,
                                       int(nbytes * self.cost_scale))
        return self.store.put(bucket, key, bytes(data))

    def head(self, bucket: str, key: str) -> ObjectMeta:
        self._sleep(self.transport.base_latency_s)
        return self.store.head(bucket, key)
