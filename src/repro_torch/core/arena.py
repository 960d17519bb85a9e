"""Zero-copy shared-memory data plane arenas (paper §4.3.1, §4.3.3).

One `TenantArena` models the per-tenant MAP_SHARED region that
Firecracker surfaces to the guest as a PCI BAR: a single pre-allocated
buffer mapped into both "address spaces" (here: shared by backend and
frontend threads), with payloads exchanged as `memoryview` slices —
never copied. Isolation invariant: an arena is private to exactly one
(tenant frontend, trusted backend) pair; the allocator refuses any
cross-tenant handle resolution (§4.3.3 "no peer-to-peer mapping").

Hint-driven prefetch allocates an *exactly sized* slot from the payload
size promoted into the RPC metadata (§4.2.2); opaque payloads fall back
to the bounded circular buffer in `streaming.py` instead.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

MB = 1024 * 1024


class ArenaError(RuntimeError):
    pass


class IsolationError(ArenaError):
    """Cross-tenant access attempt — must never succeed."""


@dataclass
class Slot:
    """A lease on [offset, offset+size) of one tenant's arena."""

    arena: "TenantArena"
    offset: int
    size: int
    used: int = 0
    released: bool = False

    def view(self) -> memoryview:
        """Zero-copy view of the payload bytes currently in the slot."""
        if self.released:
            raise ArenaError("slot already released")
        return self.arena._buf_view[self.offset:self.offset + self.used]

    def write(self, data, at: int = 0) -> int:
        """Place bytes into the slot (backend fill / frontend output)."""
        n = len(data)
        if at + n > self.size:
            raise ArenaError(f"payload {at + n}B exceeds slot {self.size}B")
        self.arena._buf_view[self.offset + at:self.offset + at + n] = data
        self.used = max(self.used, at + n)
        return n

    def release(self) -> None:
        if not self.released:
            self.released = True
            self.arena._free(self)


class TenantArena:
    """First-fit allocator over one tenant's shared region."""

    def __init__(self, tenant: str, capacity_mb: float = 64.0):
        self.tenant = tenant
        self.capacity = int(capacity_mb * MB)
        self._buf = bytearray(self.capacity)
        self._buf_view = memoryview(self._buf)
        self._lock = threading.Lock()
        self._reclaimed = threading.Condition(self._lock)
        self._free_list: list[tuple[int, int]] = [(0, self.capacity)]
        self.allocated = 0
        self.peak = 0
        self.alloc_stalls = 0

    def _try_alloc(self, size: int) -> Slot | None:
        """First-fit attempt; caller holds the lock."""
        for i, (off, length) in enumerate(self._free_list):
            if length >= size:
                if length == size:
                    self._free_list.pop(i)
                else:
                    self._free_list[i] = (off + size, length - size)
                self.allocated += size
                self.peak = max(self.peak, self.allocated)
                return Slot(self, off, size)
        return None

    def alloc(self, size: int) -> Slot:
        if size <= 0:
            raise ArenaError("size must be positive")
        with self._lock:
            slot = self._try_alloc(size)
            if slot is not None:
                return slot
        raise ArenaError(
            f"arena[{self.tenant}] exhausted: need {size}B, "
            f"{self.capacity - self.allocated}B free (fragmented)")

    def alloc_wait(self, size: int, timeout_s: float = 10.0) -> Slot:
        """Allocate, stalling on exhaustion until enough slots are
        reclaimed (arena pressure is a *transient* fault: releases
        notify waiters). Raises `ArenaError` only past `timeout_s` —
        the crash-only escalation point."""
        if size <= 0:
            raise ArenaError("size must be positive")
        with self._reclaimed:
            slot = self._try_alloc(size)
            if slot is not None:
                return slot
            self.alloc_stalls += 1
            deadline = time.monotonic() + timeout_s
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    raise ArenaError(
                        f"arena[{self.tenant}] exhausted for {timeout_s}s: "
                        f"need {size}B, "
                        f"{self.capacity - self.allocated}B free")
                self._reclaimed.wait(remaining)
                slot = self._try_alloc(size)
                if slot is not None:
                    return slot

    def _free(self, slot: Slot) -> None:
        with self._lock:
            self.allocated -= slot.size
            self._free_list.append((slot.offset, slot.size))
            # coalesce
            self._free_list.sort()
            merged: list[tuple[int, int]] = []
            for off, length in self._free_list:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1] = (merged[-1][0], merged[-1][1] + length)
                else:
                    merged.append((off, length))
            self._free_list = merged
            self._reclaimed.notify_all()

    def utilization(self) -> float:
        return self.allocated / self.capacity


class ArenaRegistry:
    """Backend-side registry enforcing one arena per tenant."""

    def __init__(self, capacity_mb: float = 64.0):
        self._arenas: dict[str, TenantArena] = {}
        self._lock = threading.Lock()
        self._capacity_mb = capacity_mb

    def get(self, tenant: str) -> TenantArena:
        with self._lock:
            if tenant not in self._arenas:
                self._arenas[tenant] = TenantArena(tenant, self._capacity_mb)
            return self._arenas[tenant]

    def resolve(self, tenant: str, slot: Slot) -> Slot:
        """Validate that `slot` belongs to `tenant`'s arena (isolation)."""
        if slot.arena is not self._arenas.get(tenant):
            raise IsolationError(
                f"tenant {tenant!r} attempted to access a foreign arena "
                f"({slot.arena.tenant!r})")
        return slot

    def total_mb(self) -> float:
        with self._lock:
            return sum(a.capacity for a in self._arenas.values()) / MB

    def drop(self, tenant: str) -> None:
        with self._lock:
            self._arenas.pop(tenant, None)
