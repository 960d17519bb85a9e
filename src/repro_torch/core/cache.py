"""SharedCache: host-side tiered payload cache.

Nexus's thesis is that the I/O backend is *shared and always-on* — so
repeated GETs for the same object (LLM weight shards, per-step KV
chains) should not pay the full fabric trip on every invocation. This
module adds the host cache as three layers:

* `CacheSpec` — the policy as pure data, shaped like `SystemSpec` /
  `GuardrailPolicy`: capacity, eviction policy (``lru`` / ``clock`` /
  seeded ``random``), admission rule (``hinted`` admits only
  hint-declared GETs, ``all`` admits every miss), write-allocation and
  cross-tenant dedup switches, and the hit service-time model
  (`hit_duration_s`). ``None`` anywhere a spec is accepted means the
  cache is disabled entirely and nothing changes.

* `CacheState` — the deterministic twin machine. BOTH executors drive
  one `CacheState` through the same three verbs (`lookup` / `fill` /
  `write`), so DES hit/miss/eviction counts are a replay-verified
  prediction of the threaded node's *by construction*: same access
  trace in, same counters out. Entries are *logical* keys (what the
  caller asked for) refcounting *content* keys (what the bytes are);
  capacity is enforced over unique content bytes, so identical weight
  shards dedup across tenants' logical keys where
  ``cross_tenant`` policy allows. Eviction is seeded and pure:
  identical operation sequences produce identical eviction sequences
  on every engine and on the threaded node.

  Count-parity contract: hits/misses/evictions match across executors
  on any serial fault-free trace whose content-identity classes agree
  (they always do while no eviction occurs; under eviction pressure,
  use traces whose payloads are pairwise distinct — the parity tests
  pin both regimes). ``dedup_bytes`` is intentionally *not* part of
  the cross-executor contract: the threaded store hashes real bytes,
  the DES reasons over declared identities.

* `SharedCache` — the threaded node's tier-1: payloads parked in a
  shared-memory arena (capacity via the existing
  `TenantArena`/`ArenaRegistry`; allocation failure falls back to
  plain host bytes so *counters never depend on fragmentation*), over
  the simulated remote `ObjectStore` tier. Consistency contract, which
  the chaos harness enforces under the full FaultSchedule matrix:

  - never stale: every hit revalidates the entry's captured etag
    against the store's current metadata; a re-driven PUT bumps the
    etag and the entry invalidates instead of serving old bytes.
    Fills bind payload + etag from one atomic store snapshot
    (`ObjectStore.get_with_meta`) and a fill that loses the insert
    race is dropped whole, so a PUT racing the modeled transfer can
    never pair its etag with older bytes; a durable overwrite also
    invalidates the resident entry even with write-allocation off;
  - never torn: payloads are published under the cache lock only
    after the full byte copy completes, and hits hand out immutable
    copies — a backend crash can abandon a fill, never expose half of
    one;
  - write-through only after durability: `put` is called by the
    backend strictly after the remote PUT committed.

A copy of ``repro.core.cache``, whole, over the port's `arena`. The port
has no DES yet, so the threaded node is the only executor that drives
`CacheState` here; the machine is the reference's, so the same operation
sequence gives the same counters and evictions in both packages.
"""
from __future__ import annotations

import hashlib
import random
import threading
from dataclasses import dataclass

from repro_torch.core.arena import ArenaError, ArenaRegistry, Slot

MB = 1024 * 1024

POLICIES = ("lru", "clock", "random")
ADMISSIONS = ("hinted", "all")


@dataclass(frozen=True)
class CacheSpec:
    """The cache plane as pure data (the whole policy surface)."""

    capacity_mb: float = 64.0      # over unique content bytes (nominal)
    policy: str = "lru"            # lru | clock | random (seeded)
    seed: int = 0                  # drives the "random" victim choice
    admit: str = "hinted"          # hinted | all
    write_allocate: bool = True    # PUTs populate the cache
    cross_tenant: bool = True      # content dedup across tenants
    hit_base_s: float = 2e-6       # arena-hit base service time
    hit_gbps: float = 80.0         # arena-hit copy bandwidth

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown eviction policy {self.policy!r} "
                             f"(choose from {POLICIES})")
        if self.admit not in ADMISSIONS:
            raise ValueError(f"unknown admission rule {self.admit!r} "
                             f"(choose from {ADMISSIONS})")
        if self.capacity_mb <= 0:
            raise ValueError("capacity_mb must be positive")
        if self.hit_base_s < 0 or self.hit_gbps <= 0:
            raise ValueError("hit service-time model must be positive")

    @property
    def capacity_bytes(self) -> int:
        return int(self.capacity_mb * MB)

    def hit_duration_s(self, nbytes: int) -> float:
        """Service time of a cache hit: base latency + arena copy."""
        return self.hit_base_s + nbytes * 8.0 / (self.hit_gbps * 1e9)


@dataclass
class _Entry:
    ck: str                        # content key this logical key maps to
    size: int                      # nominal bytes (capacity accounting)
    ref: bool = False              # clock reference bit


class CacheState:
    """Deterministic cache machine driven identically by both executors.

    Thread-safe (the threaded node's backend workers race on it); the
    DES drives it single-threaded in virtual-time order. All counters
    are integers over the operation sequence — no wall-clock anywhere.

    ``on_free(ck)`` fires (under the lock) when a content key's last
    logical reference leaves — the threaded tier drops the payload;
    ``on_evict(lk)`` fires when a logical entry leaves for any reason.
    """

    def __init__(self, spec: CacheSpec, *, on_free=None, on_evict=None):
        self.spec = spec
        self.lock = threading.RLock()
        self.on_free = on_free
        self.on_evict = on_evict
        self._entries: dict[str, _Entry] = {}       # lk -> entry (LRU order)
        self._content: dict[str, list[int]] = {}    # ck -> [size, refcount]
        self._ring: list[str] = []                  # clock: lk ring
        self._hand = 0
        self._rng = random.Random(spec.seed)
        self.used_bytes = 0
        # counters (the cross-executor contract + diagnostics)
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admitted = 0
        self.admitted_bytes = 0
        self.dedup_bytes = 0
        self.stale_invalidations = 0
        self.writes = 0

    # ------------------------------------------------------------ verbs

    def lookup(self, lk: str, valid=None) -> str | None:
        """One GET consulting the cache. Returns the content key on a
        hit, ``None`` on a miss. ``valid(lk, ck)`` — when supplied —
        must confirm the entry is still current (the threaded tier's
        etag check); a failing check invalidates the entry and counts
        as a miss, in this one code path for both executors."""
        with self.lock:
            self.lookups += 1
            ent = self._entries.get(lk)
            if ent is None:
                self.misses += 1
                return None
            if valid is not None and not valid(lk, ent.ck):
                self._remove(lk)
                self.stale_invalidations += 1
                self.misses += 1
                return None
            self.hits += 1
            self._touch(lk, ent)
            return ent.ck

    def fill(self, lk: str, ck: str, size: int, *, hinted: bool = True) -> bool:
        """Miss-path admission: offer the fetched object to the cache.
        Admitted iff the GET was hint-declared (or policy admits all)
        and the object fits. Returns True only when THIS call inserted
        the entry. A racing fill that already won returns False: the
        resident entry may hold different content (two misses can
        straddle a PUT), so the loser's payload/etag must not be bound
        to it."""
        with self.lock:
            if lk in self._entries:
                return False                     # racing fill already won
            if not (hinted or self.spec.admit == "all"):
                return False
            return self._insert(lk, ck, size)

    def write(self, lk: str, ck: str, size: int) -> bool:
        """Write-through admission after a durable PUT committed. The
        PUT is authoritative evidence that any resident entry for `lk`
        is stale, so the overwrite invalidates it even when
        write-allocation is off — correctness never rests on etag
        revalidation alone."""
        with self.lock:
            self.writes += 1
            if lk in self._entries:
                self._remove(lk)                 # overwrite: new content
            if not self.spec.write_allocate:
                return False
            return self._insert(lk, ck, size)

    def invalidate(self, lk: str) -> None:
        with self.lock:
            if lk in self._entries:
                self._remove(lk)

    # ------------------------------------------------------- internals

    def _touch(self, lk: str, ent: _Entry) -> None:
        policy = self.spec.policy
        if policy == "lru":
            self._entries[lk] = self._entries.pop(lk)   # move to MRU end
        elif policy == "clock":
            ent.ref = True

    def _insert(self, lk: str, ck: str, size: int) -> bool:
        cap = self.spec.capacity_bytes
        if size > cap:
            return False
        new_bytes = 0 if ck in self._content else size
        while self.used_bytes + new_bytes > cap:
            if not self._evict_one():
                return False                      # nothing left to evict
            new_bytes = 0 if ck in self._content else size
        rec = self._content.get(ck)
        if rec is None:
            self._content[ck] = [size, 1]
            self.used_bytes += size
        else:
            rec[1] += 1
            self.dedup_bytes += rec[0]
        self._entries[lk] = _Entry(ck, size)
        if self.spec.policy == "clock":
            self._ring.append(lk)
        self.admitted += 1
        self.admitted_bytes += size
        return True

    def _victim(self) -> str | None:
        if not self._entries:
            return None
        policy = self.spec.policy
        if policy == "lru":
            return next(iter(self._entries))      # LRU end of the dict
        if policy == "random":
            return self._rng.choice(list(self._entries))
        # clock: advance the hand, clearing reference bits, until an
        # unreferenced entry turns up (guaranteed within two sweeps).
        while True:
            if self._hand >= len(self._ring):
                self._hand = 0
            lk = self._ring[self._hand]
            ent = self._entries[lk]
            if ent.ref:
                ent.ref = False
                self._hand += 1
            else:
                return lk

    def _evict_one(self) -> bool:
        lk = self._victim()
        if lk is None:
            return False
        self._remove(lk)
        self.evictions += 1
        return True

    def _remove(self, lk: str) -> None:
        ent = self._entries.pop(lk)
        if self.spec.policy == "clock":
            i = self._ring.index(lk)
            self._ring.pop(i)
            if i < self._hand:
                self._hand -= 1
            if self._hand >= len(self._ring):
                self._hand = 0
        rec = self._content[ent.ck]
        rec[1] -= 1
        if rec[1] == 0:
            del self._content[ent.ck]
            self.used_bytes -= rec[0]
            if self.on_free is not None:
                self.on_free(ent.ck)
        if self.on_evict is not None:
            self.on_evict(lk)

    # ------------------------------------------------------ observation

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "lookups": self.lookups,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "admitted": self.admitted,
                "admitted_bytes": self.admitted_bytes,
                "dedup_bytes": self.dedup_bytes,
                "stale_invalidations": self.stale_invalidations,
                "writes": self.writes,
                "entries": len(self._entries),
                "unique_content": len(self._content),
                "used_bytes": self.used_bytes,
            }


_SHARED_ARENA = "__cache__"


class SharedCache:
    """The threaded node's tier-1: `CacheState` + arena-parked payloads.

    Owned by the `WorkerNode` (like its arenas and token table), so it
    survives backend crashes and re-attaches to every restarted
    backend — exactly the always-on host service the paper argues for.
    """

    def __init__(self, spec: CacheSpec, *, arena_mb: float | None = None):
        self.spec = spec
        self.state = CacheState(spec, on_free=self._drop_payload,
                                on_evict=self._drop_meta)
        self._lock = self.state.lock
        self._arenas = ArenaRegistry(
            arena_mb if arena_mb is not None else spec.capacity_mb)
        self._payload: dict[str, bytes | Slot] = {}   # ck -> parked bytes
        self._etag: dict[str, int] = {}               # lk -> captured etag
        self.arena_fallbacks = 0

    @staticmethod
    def _lk(bucket: str, key: str) -> str:
        return f"{bucket}/{key}"

    def _ck(self, tenant: str, data) -> str:
        digest = hashlib.sha256(data).hexdigest()
        return digest if self.spec.cross_tenant else f"{tenant}:{digest}"

    # ---------------------------------------------------- tier-1 verbs

    def get(self, tenant: str, bucket: str, key: str, store, *,
            hinted: bool = True) -> bytes | None:
        """Cache-consulting GET. Returns immutable payload bytes on a
        validated hit, ``None`` on any miss (the caller then takes the
        remote path and offers the result back via `fill`)."""
        lk = self._lk(bucket, key)

        def _valid(lk_: str, _ck: str) -> bool:
            try:
                meta = store.head(bucket, key)
            except Exception:
                return False                      # object gone: stale
            return self._etag.get(lk_) == meta.etag

        with self._lock:
            ck = self.state.lookup(lk, valid=_valid)
            if ck is None:
                return None
            parked = self._payload.get(ck)
            if parked is None:                    # defensive: payload lost
                self.state.invalidate(lk)
                return None
            if isinstance(parked, Slot):
                return bytes(parked.view())       # copy under the lock
            return parked

    def fill(self, tenant: str, bucket: str, key: str, data: bytes,
             nominal_size: int, *, hinted: bool, etag: int) -> bool:
        """Offer a freshly fetched object (miss path). `etag` must come
        from the same atomic store snapshot as `data` (see
        `ObjectStore.get_with_meta`). When a racing fill already won,
        `CacheState.fill` reports no insert and this offer is dropped
        whole: stamping OUR etag (possibly newer) onto the resident
        entry's bytes (possibly older) would create a stale hit, and
        parking a payload under an unreferenced content key would leak
        its arena slot."""
        lk = self._lk(bucket, key)
        ck = self._ck(tenant, data)
        with self._lock:
            if not self.state.fill(lk, ck, nominal_size, hinted=hinted):
                return False
            self._etag[lk] = etag
            if ck not in self._payload:
                self._payload[ck] = self._park(tenant, data)
            return True

    def put(self, tenant: str, bucket: str, key: str, data: bytes,
            nominal_size: int, etag: int) -> bool:
        """Write-through after the remote PUT committed durably."""
        lk = self._lk(bucket, key)
        ck = self._ck(tenant, data)
        with self._lock:
            if not self.state.write(lk, ck, nominal_size):
                return False
            self._etag[lk] = etag
            if ck not in self._payload:
                self._payload[ck] = self._park(tenant, data)
            return True

    # ------------------------------------------------------- internals

    def _park(self, tenant: str, data) -> bytes | Slot:
        """Copy payload bytes into the arena tier; publication happens
        in the caller under the lock only after this returns, so a
        reader can never observe a torn object. Arena exhaustion or
        fragmentation falls back to plain host bytes — the *counters*
        must not depend on allocator luck."""
        data = bytes(data)
        if not data:
            return data
        arena = self._arenas.get(
            _SHARED_ARENA if self.spec.cross_tenant else tenant)
        try:
            slot = arena.alloc(len(data))
        except ArenaError:
            self.arena_fallbacks += 1
            return data
        slot.write(data)
        return slot

    def _drop_payload(self, ck: str) -> None:
        parked = self._payload.pop(ck, None)
        if isinstance(parked, Slot):
            parked.release()

    def _drop_meta(self, lk: str) -> None:
        self._etag.pop(lk, None)

    # ------------------------------------------------------ observation

    def snapshot(self) -> dict:
        snap = self.state.snapshot()
        with self._lock:
            snap["arena_fallbacks"] = self.arena_fallbacks
            snap["arena_bytes"] = sum(
                s.size for s in self._payload.values()
                if isinstance(s, Slot))
        return snap
