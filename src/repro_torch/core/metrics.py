"""Cycle / crossing / memory accounting — the measurement plane.

The paper evaluates Nexus purely in CPU cycles (split across the four
host/guest x user/kernel domains), KVM exit + vCPU-wakeup counts, and
RSS bytes. This container has no KVM, so the runtime *accounts* these
quantities explicitly: every modeled operation charges cycles to a
domain and bumps crossing counters at the host<->guest boundary (the
TPU-framework analogue of a KVM exit is a host<->device / host<->storage
boundary crossing, per DESIGN.md). The real threaded runtime and the
discrete-event density simulator share this one accounting type, so
every benchmark reports from the same books.

A copy of ``repro.core.metrics`` holding what the port's backend and
serve driver use: the cycle domains, the crossing kinds a fabric cost
charges, `CycleAccount` and `LatencyTrace`.
"""
from __future__ import annotations

import threading
from collections import defaultdict

# Cycle domains (paper Fig. 2a / Fig. 8 notation).
GUEST_USER = "guest_user"      # Gu — user handler + in-guest fabric
GUEST_KERNEL = "guest_kernel"  # Gk — guest net stack, virtio front
HOST_USER = "host_user"        # Hu — VMM userspace, Nexus backend
HOST_KERNEL = "host_kernel"    # Hk — host net stack, KVM, vhost
DOMAINS = (GUEST_USER, GUEST_KERNEL, HOST_USER, HOST_KERNEL)

# Crossing kinds (KVM-activity analogues, paper Fig. 9).
VM_EXIT = "vm_exit"            # guest->host trap (virtio kick, MMIO, ...)
VCPU_WAKEUP = "vcpu_wakeup"    # host wakes a blocked vCPU


class CycleAccount:
    """Thread-safe per-domain cycle + crossing counters.

    Cycles are in *Mcycles* (1e6 cycles) — the natural unit for the
    paper's per-invocation numbers at 2.1 GHz.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.cycles: dict[str, float] = defaultdict(float)
        self.crossings: dict[str, int] = defaultdict(int)

    def charge(self, domain: str, mcycles: float) -> None:
        assert domain in DOMAINS, domain
        with self._lock:
            self.cycles[domain] += mcycles

    def cross(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self.crossings[kind] += n

    def total(self) -> float:
        with self._lock:
            return sum(self.cycles.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "cycles": dict(self.cycles),
                "crossings": dict(self.crossings),
                "total": sum(self.cycles.values()),
            }


class LatencyTrace:
    """Thread-safe list of (label, seconds) samples with percentiles."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._samples: dict[str, list[float]] = defaultdict(list)

    def record(self, label: str, seconds: float) -> None:
        with self._lock:
            self._samples[label].append(seconds)

    def percentile(self, label: str, q: float) -> float:
        with self._lock:
            xs = sorted(self._samples.get(label, []))
        if not xs:
            return float("nan")
        i = min(int(q / 100.0 * len(xs)), len(xs) - 1)
        return xs[i]
