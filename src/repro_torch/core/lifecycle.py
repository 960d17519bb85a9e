"""Function-instance lifecycle: snapshot restore, warm pool, release.

An instance is the unit the paper colocates by the hundred: a microVM
restored from a REAP snapshot, executing one invocation at a time on a
1-vCPU budget. Restore time scales with the recorded working-set pages
(paper Fig 13) — which is exactly where offloading the fabric pays at
cold-start time: a leaner RSS means fewer pages to insert.

`InstancePool` implements the warm pool + on-demand scaling the paper's
synchronous AWS-Lambda-style autoscaler uses, and the *early release*
that async writeback unlocks (§4.2.5): a Nexus instance returns to the
pool as soon as compute finishes, not when the output write completes.

A copy of ``repro.core.lifecycle`` without the pool methods the worker
node never calls (``start_restore_async``, ``scale_down``,
``total_rss_mb``).
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

from repro_torch.core import fabric as F
from repro_torch.core import metrics as M
from repro_torch.core.plan import SystemSpec
from repro_torch.core.workloads import Workload

_iid = itertools.count()


@dataclass
class RestoreBreakdown:
    create_s: float = 0.0
    ws_insert_s: float = 0.0
    ws_pages: int = 0

    @property
    def total_s(self) -> float:
        return self.create_s + self.ws_insert_s


class FunctionInstance:
    """One microVM hosting one function; executes invocations serially."""

    def __init__(self, workload: Workload, spec: SystemSpec,
                 acct: M.CycleAccount, sleep=time.sleep,
                 fault_hooks=None):
        self.id = next(_iid)
        self.workload = workload
        self.spec = spec
        self.acct = acct
        self._sleep = sleep
        self._busy = threading.Lock()
        self.state = "cold"
        # FaultPlane tap (faults.FaultHooks.restore_fail): a failed
        # snapshot restore costs a full extra restore pass
        self.fault_hooks = fault_hooks
        self.restore_retries = 0
        # the memory variant (and with it the snapshot working set) is
        # spec data — adding a system variant cannot silently fall back
        # to the wrong footprint.
        self.memory = F.instance_memory(workload.extra_libs_mb,
                                        spec.memory_variant)
        self.restore_info: RestoreBreakdown | None = None

    @property
    def rss_mb(self) -> float:
        return self.memory.total()

    def restore(self) -> RestoreBreakdown:
        """Snapshot restore (REAP): create uVM + insert working set.

        A restore-failure fault (FaultPlane) wastes the whole attempt —
        the retry pays the full create + working-set insert again, and
        the page-fault cycles of the dead attempt are still charged.
        Bounded at 2 failed attempts per restore so a long fault window
        cannot livelock a cold start."""
        pages = F.working_set_pages_components(self.memory)
        bd = RestoreBreakdown(
            create_s=F.SNAPSHOT_FIXED_S,
            ws_insert_s=pages * F.RESTORE_US_PER_PAGE * 1e-6,
            ws_pages=pages)
        hooks = self.fault_hooks
        while (hooks is not None and hooks.restore_fail is not None
               and self.restore_retries < 2 and hooks.restore_fail()):
            self.restore_retries += 1
            self._sleep(bd.total_s)          # the dead attempt's cost
            self.acct.charge(M.HOST_KERNEL, pages * 2.0e-3)
        self._sleep(bd.total_s)
        # page-fault handling burns host-kernel cycles + exits (no VM
        # boundary -> no exits for the wasm sandbox)
        self.acct.charge(M.HOST_KERNEL, pages * 2.0e-3)
        if self.spec.virtualized:
            self.acct.cross(M.VM_EXIT, pages // 8)  # REAP batches faults
        # a cold acquire restores while the busy lock is already held —
        # the instance is NOT idle-warm until its release()
        self.state = "busy" if self._busy.locked() else "warm"
        self.restore_info = bd
        return bd

    def acquire(self) -> bool:
        """Claim the instance for one invocation (1 vCPU => serial)."""
        ok = self._busy.acquire(blocking=False)
        if ok:
            self.state = "busy"
        return ok

    def release(self) -> None:
        self.state = "warm"
        self._busy.release()

    def account_compute(self, mcycles: float, real_s: float) -> None:
        """Close one handler compute segment: the handler's real work
        between two I/O calls took `real_s` on this thread; pad it up to
        the modeled vCPU time at the paper's 2.1 GHz (scaled by the
        spec's handler cost class, e.g. the wasm variant's C++ ports)
        and account cycles + busy-guest crossings."""
        scaled = mcycles * self.spec.compute_scale
        modeled = scaled / F.GHZ_MCYC_PER_S
        remaining = modeled - real_s
        if remaining > 0:
            self._sleep(remaining)
        self.acct.charge(M.GUEST_USER, scaled)
        # busy-guest exits (syscalls/GC/timers) that offloading can't remove
        if self.spec.virtualized:
            exits = max(int(modeled * F.COMPUTE_EXITS_PER_SEC), 1)
            self.acct.cross(M.VM_EXIT, exits)
            self.acct.cross(M.VCPU_WAKEUP,
                            int(exits * F.COMPUTE_WAKEUPS_PER_EXIT))


class InstancePool:
    """Per-function pool with warm reuse and on-demand cold starts."""

    def __init__(self, workload: Workload, spec: SystemSpec,
                 acct: M.CycleAccount, sleep=time.sleep,
                 max_instances: int = 64, fault_hooks=None):
        self.workload = workload
        self.spec = spec
        self.acct = acct
        self._sleep = sleep
        self.max_instances = max_instances
        self.fault_hooks = fault_hooks
        self._lock = threading.Lock()
        self._instances: list[FunctionInstance] = []
        self.cold_starts = 0
        self.warm_hits = 0

    def instances(self) -> list[FunctionInstance]:
        with self._lock:
            return list(self._instances)

    def has_warm(self) -> bool:
        with self._lock:
            return any(i.state == "warm" for i in self._instances)

    def acquire(self) -> tuple[FunctionInstance, bool]:
        """Returns (instance, was_cold). Restores a new uVM if needed."""
        with self._lock:
            for inst in self._instances:
                if inst.state == "warm" and inst.acquire():
                    self.warm_hits += 1
                    return inst, False
            if len(self._instances) >= self.max_instances:
                raise RuntimeError(
                    f"{self.workload.name}: instance cap reached")
            inst = FunctionInstance(self.workload, self.spec, self.acct,
                                    self._sleep,
                                    fault_hooks=self.fault_hooks)
            assert inst.acquire()
            self._instances.append(inst)
            self.cold_starts += 1
        inst.restore()          # outside the pool lock: restores overlap
        return inst, True
