"""Worker-node runtime: the anatomy of an invocation (paper §4.2).

One `WorkerNode` executes every system variant in `plan.SYSTEMS` by
interpreting its compiled `PhasePlan` with REAL threads over REAL
bytes: restores overlap with prefetches because two threads really run
concurrently; zero-copy is real (`memoryview` into the tenant arena);
crashes really kill the backend mid-flight. Latencies are modeled
constants (slept); cycles/crossings are accounted per §3's calibration.
``byte_scale`` shrinks *real* payload bytes to keep Python hashing off
the critical path while hints/costs use nominal sizes.

The guest is a conventional FaaS function: ``handler(event, ctx)``
running on its own thread, issuing its own ``get_object``/``put_object``
calls through the injected ``ctx.storage`` (`frontend.S3Api`). The
plan walker does not perform the handler's I/O — it *observes* it:
`_GuestRun` intercepts every client call, matches it against the
workload's declared `IOProfile`, and completes the corresponding
fetch/compute/write group; platform phases (restore, rpc_in, connect,
reply, the ingress prefetch of the first hinted GET, async-writeback
ack gating) remain walker actions. There is deliberately NO
per-variant control flow here: phase ordering, overlap, and the
release/response barriers all come from
`plan.compile_plan(spec, profile)`.

A copy of ``repro.core.runtime``, line for line but for three
deviations:

* ``device`` — a keyword naming where the handlers' tensors live, the
  card by default (`repro_torch.device.resolve_device`: without a card
  the node raises unless the caller asks for ``"cpu"``). It reaches each
  handler as ``ctx.device`` (`frontend.HandlerContext`).
* ``arena_mb`` — a keyword, 64 MB by default (the reference's
  `ArenaRegistry` default), forwarded to the tenant arenas the backend
  allocates; a payload larger than the arena needs a larger one.
* ``connect_timeout_s`` — the ingress-prefetch deadline also bounds the
  guest stub's wait for that prefetch (`frontend.NexusClient`'s
  ``prefetch_timeout_s``; the reference's stub waits a fixed 30 s, its
  default for this deadline). At the defaults nothing changes.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core import fabric as F
from repro_torch.core import guardrails as GR
from repro_torch.core import metrics as M
from repro_torch.core.analysis.diag import (PC_CONTRACT, PC_DUP_KEY,
                                            ProfileContractError)
from repro_torch.core.backend import NexusBackend
from repro_torch.core.cache import CacheSpec, SharedCache
from repro_torch.core.faults import FaultHooks
from repro_torch.core.frontend import (BaselineClient, GuestContext,
                                       HandlerContext, NexusClient)
from repro_torch.core.hints import extract_hints, make_event
from repro_torch.core.lifecycle import InstancePool
from repro_torch.core.plan import (SYSTEMS, PhasePlan, PlanProgram,
                                   SystemSpec, compile_program,
                                   unloaded_latency)
from repro_torch.core.transport import TRANSPORTS
from repro_torch.core.storage import FaultPlan, ObjectStore, RemoteStorage
from repro_torch.core.supervisor import Supervisor
from repro_torch.core.workloads import (ComputeSegment, Get, IOProfile, Put,
                                        REGISTRY, Workload)
from repro_torch.device import resolve_device

__all__ = ["SYSTEMS", "SystemSpec", "WorkerNode", "InvocationResult"]

MB = 1024 * 1024


@dataclass
class InvocationResult:
    invocation_id: str
    function: str
    cold: bool
    latency_s: float
    breakdown: dict[str, float] = field(default_factory=dict)
    output_etag: int | None = None            # first durable PUT
    output_etags: tuple = ()                  # every durable PUT, in order
    response: Any = None                      # the handler's return value


class _Invocation:
    """Mutable state one invocation threads through the walker + guest."""

    def __init__(self, w: Workload, inv_id: str, event: dict,
                 cold_expected: bool, t0: float):
        self.w = w
        self.inv_id = inv_id
        self.event = event
        self.inputs, self.outputs = extract_hints(event)
        self.cold_expected = cold_expected
        self.t0 = t0
        self.inst = None
        self.cold = False
        self.client = None
        self.gctx: GuestContext | None = None
        self.guest: "_GuestRun | None" = None
        self.vm_busy: float | None = None
        self._rel_lock = threading.Lock()
        self._released = False

    def release_instance(self) -> None:
        """Idempotent release barrier — fired where the plan says."""
        with self._rel_lock:
            if self._released or self.inst is None:
                return
            self._released = True
        self.vm_busy = time.monotonic() - self.t0
        self.inst.release()


class _GuestRun:
    """The guest side of one invocation: runs ``handler(event, ctx)`` on
    a real thread and is itself the `S3Api` the handler receives.

    Interception contract: the handler's k-th GET/PUT call is matched
    against the k-th `Get`/`Put` of the (effective) `IOProfile`; wall
    time between I/O calls is attributed to the `ComputeSegment`s
    declared between them (padded to the modeled vCPU time). Each
    matched op fires a completion event the plan walker's corresponding
    group action waits on — the walker observes, it does not perform.
    Divergence between handler and profile is an invocation error.
    """

    def __init__(self, node: "WorkerNode", ctx: _Invocation,
                 profile: IOProfile, stall_timeout_s: float):
        self._node = node
        self._ctx = ctx
        self._ops = profile.ops
        self._stall = stall_timeout_s
        self._oi = 0                 # program counter into the profile
        self._gi = self._pi = self._ci = 0
        self._seg_t0: float | None = None
        self._slots: list = []
        self._written: set[tuple[str, str]] = set()
        gets = profile.gets
        #: get-ordinal served by the ingress prefetch (first hinted GET)
        self.prefetch_op = (0 if (node.spec.prefetch and gets
                                  and gets[0].prefetchable) else None)
        self._opaque = {i: not g.prefetchable for i, g in enumerate(gets)}
        self.tickets: dict[int, Any] = {}     # async put ordinal -> ticket
        self.etags: dict[int, int] = {}
        self.error: BaseException | None = None
        self.handler_result: Any = None
        self._events: dict[str, threading.Event] = {}
        for i in range(len(gets)):
            self._events[f"fetch[{i}]"] = threading.Event()
        for j in range(len(profile.segments)):
            self._events[f"compute[{j}]"] = threading.Event()
        for k in range(len(profile.puts)):
            self._events[f"write[{k}]"] = threading.Event()
        self._prefetch_ready = threading.Event()
        self._started = False
        self._start_lock = threading.Lock()

    # ---------------------------------------------------- walker interface

    def start(self) -> None:
        """Launch the handler thread (once the VM is up and the event
        delivered — the walker fires this on restore ∧ rpc_in)."""
        with self._start_lock:
            if self._started:
                return
            self._started = True
        threading.Thread(target=self._main, daemon=True).start()

    def set_prefetch(self, handle) -> None:
        """The walker's ingress-prefetch action hands the guest stub its
        in-flight handle; the first GET then returns the arena view."""
        self._ctx.gctx.prefetch = handle
        self._prefetch_ready.set()

    def await_group(self, group: str) -> None:
        """Block until the handler completes `group`'s op (the walker's
        observation point for guest-driven fetch/compute/write groups)."""
        if not self._events[group].wait(self._stall):
            raise TimeoutError(
                f"{self._ctx.w.name}: guest never completed {group}")
        if self.error is not None:
            raise self.error

    # --------------------------------------------------------- guest main

    def _main(self) -> None:
        inv = self._ctx
        try:
            self._seg_t0 = time.monotonic()
            hctx = HandlerContext(
                storage=self, invocation_id=inv.inv_id,
                function_name=inv.w.name, cold_start=inv.cold,
                device=self._node.device)
            self.handler_result = inv.w.handler(inv.event, hctx)
            self._close_segments()
            if self._oi != len(self._ops):
                remaining = [type(op).__name__
                             for op in self._ops[self._oi:]]
                raise ProfileContractError(
                    PC_CONTRACT,
                    f"handler returned with declared I/O unperformed "
                    f"(op {self._oi} of {len(self._ops)} in its "
                    f"IOProfile; still due: {remaining})",
                    subject=inv.w.name, op_index=self._oi)
        except BaseException as e:           # noqa: BLE001 — propagated
            self.error = e
        finally:
            for slot in self._slots:
                try:
                    slot.release()
                except Exception:            # noqa: BLE001
                    pass
            for ev in self._events.values():
                ev.set()                     # wake the walker; it re-raises

    # ----------------------------------------------------- S3Api surface

    def get_object(self, Bucket: str, Key: str) -> dict:
        self._close_segments()
        i = self._expect(Get)
        inv, spec = self._ctx, self._node.spec
        if spec.coupled:
            obj = inv.client.get_object(Bucket=Bucket, Key=Key)
        elif i == self.prefetch_op:
            # the walker started the hinted prefetch at ingress; wait for
            # the handle, then take the zero-copy fast path (§4.2.4)
            if not self._prefetch_ready.wait(self._stall):
                raise TimeoutError(
                    f"{inv.w.name}: ingress prefetch never started")
            obj = inv.client.get_object(Bucket=Bucket, Key=Key)
        elif self._opaque.get(i, True):
            # size-opaque inputs use the streaming fallback (§4.2.3):
            # no exactly-sized region can be pre-mapped
            buf = inv.client.get_object_streaming(Bucket=Bucket, Key=Key)
            data = buf.read_all()
            obj = {"Body": memoryview(data), "ContentLength": len(data)}
        else:
            obj = inv.client.get_object(Bucket=Bucket, Key=Key)
        slot = obj.pop("_slot", None)
        if slot is not None:
            self._slots.append(slot)
        self._events[f"fetch[{i}]"].set()
        self._seg_t0 = time.monotonic()
        return obj

    def put_object(self, Bucket: str, Key: str, Body) -> dict:
        self._close_segments()
        k = self._expect(Put)
        inv, node = self._ctx, self._node
        # two durable writes to one key in a single invocation have no
        # defined order once write chains float (async writeback) — and
        # the backend's per-logical-write retry dedup would silently
        # drop the second. Reject, variant-independently.
        if (Bucket, Key) in self._written:
            raise ProfileContractError(
                PC_DUP_KEY,
                f"handler wrote {Bucket}/{Key} twice in one invocation "
                f"({self._handler_site()}) — duplicate durable PUTs are "
                f"unordered under async writeback",
                subject=inv.w.name, op_index=self._oi)
        self._written.add((Bucket, Key))
        # handlers emit nominal-size outputs; the platform stores the
        # byte-scaled prefix while every cost model charges full size
        real = bytes(memoryview(Body)[:max(int(len(Body) * node.byte_scale),
                                           1)])
        etag = None
        if node.spec.coupled:
            etag = inv.client.put_object(Bucket=Bucket, Key=Key,
                                         Body=real).etag
            self.etags[k] = etag
        elif node.spec.async_writeback:
            # hand off and continue; the walker's write action gates the
            # response on the ack (§4.2.5)
            self.tickets[k] = inv.client.put_object(
                Bucket=Bucket, Key=Key, Body=real, wait=False)
        else:
            etag = inv.client.put_object(Bucket=Bucket, Key=Key, Body=real,
                                         wait=True)
            self.etags[k] = etag
        self._events[f"write[{k}]"].set()
        self._seg_t0 = time.monotonic()
        return {"ETag": etag}

    # ------------------------------------------------------------ matching

    def _close_segments(self) -> None:
        """Attribute handler wall time since the last I/O call to the
        compute segments declared at the current profile position."""
        while (self._oi < len(self._ops)
               and isinstance(self._ops[self._oi], ComputeSegment)):
            seg = self._ops[self._oi]
            real = time.monotonic() - self._seg_t0
            self._ctx.inst.account_compute(seg.mcycles, real)
            self._seg_t0 = time.monotonic()
            self._events[f"compute[{self._ci}]"].set()
            self._ci += 1
            self._oi += 1

    def _handler_site(self) -> str:
        """The handler source line the current storage call was issued
        from: walk the live stack down to the frame executing the
        handler's own code object (the call may arrive through helper
        functions)."""
        code = getattr(self._ctx.w.handler, "__code__", None)
        frame = sys._getframe(1)
        while frame is not None and code is not None \
                and frame.f_code is not code:
            frame = frame.f_back
        if frame is None or code is None:
            return "handler line unknown"
        return f"{code.co_filename}:{frame.f_lineno}"

    def _expect(self, kind) -> int:
        if (self._oi >= len(self._ops)
                or not isinstance(self._ops[self._oi], kind)):
            declared = (type(self._ops[self._oi]).__name__
                        if self._oi < len(self._ops) else "end-of-profile")
            io_i = sum(1 for op in self._ops[:self._oi]
                       if not isinstance(op, ComputeSegment))
            raise ProfileContractError(
                PC_CONTRACT,
                f"handler issued {kind.__name__} at op {self._oi} "
                f"(I/O call #{io_i}, {self._handler_site()}) but its "
                f"IOProfile declares {declared}",
                subject=self._ctx.w.name, op_index=self._oi)
        self._oi += 1
        if kind is Get:
            self._gi += 1
            return self._gi - 1
        self._pi += 1
        return self._pi - 1


class _PlanRun:
    """Walk one lowered program's breakdown groups on real threads.

    Drives off the same `plan.PlanProgram` the density simulator
    interprets — at breakdown-group granularity: an integer indegree
    countdown over `group_succ` index lists, exactly the DES's
    per-phase discipline (the old walker re-scanned every group's
    name-keyed dependency set after each completion). One lowered
    representation, two executors — they cannot drift.

    Each group runs as soon as its dependencies complete; parallel
    branches (prefetch vs restore) get real threads; barriers fire as
    completion hooks. Per-group wall time is recorded as the breakdown.
    """

    def __init__(self, program: PlanProgram, actions: dict,
                 ctx: _Invocation, stall_timeout_s: float = 120.0):
        self._program = program
        self._names = program.group_names
        self._succ = program.group_succ
        self._actions = [actions[g] for g in self._names]
        self._ctx = ctx
        self._stall = stall_timeout_s
        self._need = list(program.group_indegree)
        self._hooks: dict[int, callable] = {}
        self.breakdown: dict[str, float] = {}
        self._lock = threading.Lock()
        self._started = [False] * len(self._names)
        self._n_done = 0
        self._active = 0
        self._error: BaseException | None = None
        self._finished = threading.Event()

    def on_complete(self, group: str, hook) -> None:
        self._hooks[self._names.index(group)] = hook

    def run(self) -> dict[str, float]:
        roots = self._program.group_roots
        for gi in roots[1:]:
            threading.Thread(target=self._chain, args=(gi,),
                             daemon=True).start()
        self._chain(roots[0])
        if not self._finished.wait(timeout=self._stall):
            done = [n for n, f in zip(self._names, self._started) if f]
            raise TimeoutError(
                f"plan run stalled ({self._program.plan.system}): "
                f"started={done} of {list(self._names)}")
        if self._error is not None:
            raise self._error
        return self.breakdown

    def _chain(self, gi: int | None) -> None:
        while gi is not None:
            with self._lock:
                if self._started[gi] or self._error is not None:
                    return
                self._started[gi] = True
                self._active += 1
            t0 = time.monotonic()
            try:
                self._actions[gi](self._ctx)
            except BaseException as e:              # noqa: BLE001
                with self._lock:
                    self._active -= 1
                    if self._error is None:
                        self._error = e
                    if self._active == 0:
                        self._finished.set()
                return
            self.breakdown[self._names[gi]] = time.monotonic() - t0
            hook = self._hooks.get(gi)
            if hook is not None:
                hook()
            with self._lock:
                self._active -= 1
                self._n_done += 1
                if self._error is not None:
                    if self._active == 0:
                        self._finished.set()
                    return
                if self._n_done == len(self._names):
                    self._finished.set()
                    return
                need = self._need
                ready = []
                for si in self._succ[gi]:
                    need[si] -= 1
                    if need[si] == 0 and not self._started[si]:
                        ready.append(si)
            for g in ready[1:]:
                threading.Thread(target=self._chain, args=(g,),
                                 daemon=True).start()
            gi = ready[0] if ready else None


class WorkerNode:
    """One worker node running a system variant over deployed workloads."""

    def __init__(self, system: str, *, store: ObjectStore | None = None,
                 byte_scale: float = 1 / 32, workers: int = 32,
                 faults: FaultPlan | None = None,
                 hedge_after_s: float | None = None,
                 max_instances_per_fn: int = 64,
                 writeback_ack_timeout_s: float = 30.0,
                 plan_stall_timeout_s: float = 120.0,
                 static_check: bool = True,
                 guardrails: "GR.GuardrailPolicy | None" = None,
                 cache: CacheSpec | None = None,
                 client_max_retries: int = 3,
                 retry_backoff_base_s: float = 0.002,
                 connect_timeout_s: float = 30.0,
                 device=None,
                 arena_mb: float = 64.0):
        self.spec = SYSTEMS[system]
        #: where the handlers' tensors live: the card unless the caller
        #: asks for the CPU (raises without a card)
        self.device = resolve_device(device)
        #: capacity of each tenant's arena (the reference's default is
        #: 64 MB); a hinted GET or a PUT larger than it cannot land
        self.arena_mb = arena_mb
        #: registration-time ProfileInfer gate: `deploy` statically
        #: verifies each handler against its declared IOProfile and
        #: rejects mismatches before any invocation runs. Disable to
        #: exercise the runtime contract path (or to deploy handlers
        #: the analyzer cannot see, e.g. generated code).
        self.static_check = static_check
        self.acct = M.CycleAccount()
        self.latency = M.LatencyTrace()
        self.byte_scale = byte_scale
        #: deadline for a durable-write ack to resolve (blocking PUTs and
        #: the async-writeback response gate alike)
        self.writeback_ack_timeout_s = writeback_ack_timeout_s
        #: upper bound on any one plan walk / guest observation wait
        self.plan_stall_timeout_s = plan_stall_timeout_s
        #: client retry budget per storage RPC — the bounded attempt
        #: count the `NexusClient` loops draw from (was a hardcoded
        #: ``max_retries=3`` inside the stub). A `guardrails.RetrySpec`
        #: on the policy overrides both retry knobs wholesale.
        self.client_max_retries = client_max_retries
        #: first backoff sleep after a failed RPC attempt; doubles per
        #: retry with deterministic jitter (was a fixed 2 ms
        #: ``Event().wait`` in the stub's retry loop).
        self.retry_backoff_base_s = retry_backoff_base_s
        #: deadline for the ingress prefetch — per-VM storage connect +
        #: first hinted GET — to land (was pinned to
        #: ``plan_stall_timeout_s``).
        self.connect_timeout_s = connect_timeout_s
        #: GuardRails policy plane (overload control, §GuardRails):
        #: admission, deadlines, retry budgets, breaker, drain — one
        #: `GuardrailPolicy` value, interpreted here over the node's
        #: uptime clock and by `des.DensitySimulator` in virtual time.
        #: The `GuardState` always exists (empty policy => admit all)
        #: so `drain()`/`resume()` work on any node.
        self.guardrails = (guardrails if guardrails is not None
                           else GR.GuardrailPolicy())
        #: SharedCache plane (§SharedCache): node-owned like the arena
        #: registry and token vault — it survives backend crashes and is
        #: re-attached by `_make_backend`, so a supervisor restart never
        #: cold-starts the cache (crash safety is the etag revalidation's
        #: job, not eviction's).
        #: the arena tier holds REAL (byte-scaled) payloads while the
        #: capacity/ counters reason over nominal sizes — size the
        #: backing region accordingly (TenantArena preallocates it)
        self.cache_plane = (
            SharedCache(cache,
                        arena_mb=max(1.0, cache.capacity_mb * byte_scale))
            if cache is not None else None)
        self._t0 = time.monotonic()
        self.guard = GR.GuardState(
            self.guardrails, clock=lambda: time.monotonic() - self._t0)
        self._retry_spec = (
            self.guardrails.retry if self.guardrails.retry is not None
            else GR.RetrySpec(max_attempts=client_max_retries,
                              backoff_base_s=retry_backoff_base_s))
        self._unloaded: dict[str, float] = {}
        self._inflight = 0
        self._quiesce = threading.Condition()
        #: FaultPlane taps — `faults.FaultInjector` arms these from a
        #: `FaultSchedule`; every component reads them at call time, so
        #: the injection survives supervisor backend restarts.
        self.fault_hooks = FaultHooks()
        self.store = store if store is not None else ObjectStore()
        self.remote = RemoteStorage(
            self.store, self.spec.transport, self.acct,
            hedge_after_s=hedge_after_s, faults=faults,
            cost_scale=1.0 / byte_scale)
        self._pools: dict[str, InstancePool] = {}
        self._workloads: dict[str, Workload] = {}
        self._creds: dict[str, str] = {}
        self._ingress = ThreadPoolExecutor(max_workers=workers,
                                           thread_name_prefix="ingress")
        self._inv_counter = itertools.count()
        self._max_instances = max_instances_per_fn

        if not self.spec.coupled:
            self.supervisor = Supervisor(self._make_backend)
            self.supervisor.start()
        else:
            self.supervisor = None

    # ------------------------------------------------------------- plumbing

    def _make_backend(self) -> NexusBackend:
        # arena registry + token vault live with the node/orchestrator
        # and are re-attached across backend restarts (crash-only, §5).
        if not hasattr(self, "_arenas"):
            from repro_torch.core.arena import ArenaRegistry
            from repro_torch.core.credentials import TokenManager
            self._arenas = ArenaRegistry(self.arena_mb)
            self._tokens = TokenManager()
        return NexusBackend(self.remote, self.acct,
                            transport_name=self.spec.transport,
                            arenas=self._arenas, tokens=self._tokens,
                            fault_hooks=self.fault_hooks,
                            cache=self.cache_plane)

    @property
    def backend(self) -> NexusBackend | None:
        return self.supervisor.backend if self.supervisor else None

    def deploy(self, fn: str | Workload) -> None:
        """Deploy a workload by registry name or as a `Workload` value
        (a custom handler + IOProfile — the programming-model surface).

        With ``static_check`` (the default), ProfileInfer statically
        recovers the handler's storage-call sequence and rejects the
        deployment with a `PlanCheckError` when it cannot match the
        declared IOProfile — the same divergence the runtime contract
        would hit mid-invocation, caught before any instance exists."""
        w = fn if isinstance(fn, Workload) else REGISTRY[fn]
        if self.static_check:
            from repro_torch.core.analysis.infer import check_workload
            check_workload(w)
        self._workloads[w.name] = w
        self._pools[w.name] = InstancePool(
            w, self.spec, self.acct, max_instances=self._max_instances,
            fault_hooks=self.fault_hooks)
        if self.supervisor:
            self._creds[w.name] = self.backend.register_function(
                w.name, {"in", "out"})

    @staticmethod
    def _input_key(fn_name: str, i: int) -> str:
        return f"{fn_name}-input" if i == 0 else f"{fn_name}-input-{i}"

    def seed_input(self, fn_name: str, key: str | None = None,
                   payloads: "list[bytes] | None" = None) -> list[str]:
        """Stage every declared input object in remote storage (one per
        `Get` in the workload's IOProfile); returns the keys.

        By default each object is synthetic filler at the byte-scaled
        declared size. `payloads` seeds REAL bytes verbatim instead
        (one per `Get`, byte_scale must be 1.0 so the handler sees them
        untouched) — the MLServe path stages serialized params/KV
        tensors this way.
        """
        w = self._workloads[fn_name]
        if payloads is not None:
            if len(payloads) != len(w.profile.gets):
                raise ValueError(
                    f"{fn_name}: {len(payloads)} payloads for "
                    f"{len(w.profile.gets)} declared GETs")
            if self.byte_scale != 1.0:
                # scaled nodes truncate PUT bodies and size costs by
                # byte_scale — real payloads would be corrupted deep in
                # the handler; fail here, where the mistake is.
                raise ValueError(
                    f"{fn_name}: seeding real payloads requires "
                    f"byte_scale=1.0 (node has {self.byte_scale})")
        keys = []
        for i, g in enumerate(w.profile.gets):
            k = key if (key is not None and i == 0) \
                else self._input_key(fn_name, i)
            if payloads is not None:
                data = bytes(payloads[i])
            else:
                real = max(int(g.size_bytes * self.byte_scale), 1024)
                data = bytes([i % 251]) * real
            self.store.put("in", k, data)
            keys.append(k)
        return keys

    # ------------------------------------------------------------- metrics

    def cache_stats(self) -> dict | None:
        """SharedCache counter snapshot (None when the node runs
        cache-less) — the threaded side of the DES parity contract."""
        return (self.cache_plane.snapshot()
                if self.cache_plane is not None else None)

    def node_memory_mb(self) -> M.MemoryAccount:
        acct = M.MemoryAccount()
        n = 0
        for pool in self._pools.values():
            for inst in pool.instances():
                n += 1
                for comp, mb in inst.memory.components.items():
                    acct.add(comp, mb)
        if self.backend is not None:
            acct.add("nexus_backend", self.backend.memory_mb(n))
        return acct

    # ----------------------------------------------------------- invocation

    def invoke(self, fn_name: str, *, input_key: str | None = None,
               opaque: bool = False,
               inv_id: str | None = None) -> "Future[InvocationResult]":
        """Submit one invocation; returns the caller's response future.
        The future resolves only after every output is durably written
        (at-least-once, §4.2.5) — even under async writeback.

        `inv_id` pins the invocation id (and with it every output key
        and PUT idempotency key): a caller re-driving a failed
        invocation under the same id gets at-least-once semantics with
        byte-identical durable state — the chaos harness's contract.

        GuardRails admission runs here, before any work: a shed
        arrival raises a typed `guardrails.Rejected` (or
        `DeadlineExceeded` under deadline propagation) atomically —
        no instance acquired, no bytes moved, zero partial PUTs. A
        "queue" verdict paces the invocation by the bucket delay; the
        recorded latency includes the wait, exactly as in the DES.
        """
        if inv_id is None:
            inv_id = (f"{fn_name}-{next(self._inv_counter)}"
                      f"-{uuid.uuid4().hex[:6]}")
        w = self._workloads[fn_name]
        u = None
        if not self.guard.policy.is_empty:
            u = self._unloaded.get(fn_name)
            if u is None:
                u = self._unloaded[fn_name] = unloaded_latency(self.spec, w)
        verdict = self.guard.decide(fn_name, fn_name, u)
        if verdict.action == "shed":
            self.acct.cross(M.SHED)
            exc = (GR.DeadlineExceeded if verdict.reason == "deadline"
                   else GR.Rejected)
            raise exc(verdict.reason, retry_after_s=verdict.delay_s)
        inputs = []
        for i, g in enumerate(w.profile.gets):
            k = input_key if (input_key is not None and i == 0) \
                else self._input_key(fn_name, i)
            size = (None if opaque or not w.deterministic_input
                    else self.store.head("in", k).size)
            # a Get declared cacheable=False rides the event as an
            # explicit `"cache": false` header — the SharedCache opt-out
            # travels with the hint, exactly like the size promotion
            inputs.append(("in", k, size, g.cacheable))
        outputs = [("out", f"{inv_id}-out" + ("" if k == 0 else f"-{k}"))
                   for k in range(len(w.profile.puts))]
        event = make_event(inputs, outputs)
        with self._quiesce:
            self._inflight += 1
        try:
            return self._ingress.submit(self._run, w, inv_id, event,
                                        verdict.delay_s)
        except BaseException:
            with self._quiesce:
                self._inflight -= 1
                self._quiesce.notify_all()
            raise

    def _run(self, w: Workload, inv_id: str, event: dict,
             pace_s: float = 0.0) -> InvocationResult:
        t0 = time.monotonic()
        if pace_s > 0.0:
            # admission pacing: the bucket said "queue" — latency is
            # measured from submission, so the wait shows up in it
            time.sleep(pace_s)
        try:
            return self._run_inner(w, inv_id, event, t0)
        finally:
            with self._quiesce:
                self._inflight -= 1
                if self._inflight == 0:
                    self._quiesce.notify_all()

    def _run_inner(self, w: Workload, inv_id: str, event: dict,
                   t0: float) -> InvocationResult:
        pool = self._pools[w.name]
        cold_expected = not pool.has_warm()
        ctx = _Invocation(w, inv_id, event, cold_expected, t0)
        # the *effective* profile for this invocation is still pure
        # data: a declared-prefetchable GET whose event hint is missing
        # or size-opaque cannot be prefetched (§4.2.3) — its fetch chain
        # correctly serializes after the restore.
        profile = w.profile.effective(ctx.inputs)
        program = compile_program(
            self.spec, profile, cold=cold_expected,
            kernel_bypass=TRANSPORTS[self.spec.transport].kernel_bypass)
        plan = program.plan
        self._make_client(ctx, profile)
        guest = _GuestRun(self, ctx, profile, self.plan_stall_timeout_s)
        ctx.guest = guest

        run = _PlanRun(program, self._build_actions(plan, guest), ctx,
                       stall_timeout_s=self.plan_stall_timeout_s)
        # the guest program starts when the VM is up AND the event has
        # been delivered — exactly the restore ∧ rpc_in join.
        gate: set[str] = set()
        gate_lock = threading.Lock()

        def _start_gate(g):
            def hook():
                with gate_lock:
                    gate.add(g)
                    ready = {"restore", "rpc_in"} <= gate
                if ready:
                    guest.start()
            return hook

        run.on_complete("restore", _start_gate("restore"))
        run.on_complete("rpc_in", _start_gate("rpc_in"))
        run.on_complete(plan.release_group, ctx.release_instance)
        try:
            bd = dict(run.run())
        finally:
            ctx.release_instance()       # exactly-once, also on failure
            # a prefetch the handler never consumed (e.g. it read its
            # inputs in a different order than the event hints) still
            # holds an arena slot — reclaim it. NexusClient clears
            # gctx.prefetch on consumption, so this cannot double-free.
            pf = ctx.gctx.prefetch if ctx.gctx is not None else None
            if pf is not None and pf.ready.is_set() and pf.slot is not None:
                pf.slot.release()
        if ctx.vm_busy is not None:
            bd["vm_busy"] = ctx.vm_busy

        lat = time.monotonic() - t0
        self.latency.record(f"{w.name}:{'cold' if ctx.cold else 'warm'}",
                            lat)
        etags = tuple(guest.etags.get(k)
                      for k in range(len(profile.puts)))
        res = InvocationResult(inv_id, w.name, ctx.cold, lat, bd,
                               etags[0] if etags else None, etags,
                               guest.handler_result)
        dl = self.guard.deadline_for(w.name, self._unloaded.get(w.name))
        if dl is not None and lat > dl:
            # the work IS durably done (at-least-once holds) — only the
            # response is typed as late; the full result rides along.
            self.guard.note_violation()
            raise GR.DeadlineExceeded("deadline", result=res)
        return res

    def _make_client(self, ctx: _Invocation,
                     profile: IOProfile | None = None) -> None:
        spec = self.spec
        if spec.coupled:
            hooks = self.fault_hooks
            ctx.client = BaselineClient(
                self.remote, self.acct, lang=spec.guest_lang,
                sdk=spec.sdk, virtualized=spec.virtualized,
                fault=lambda: (hooks.guest_crash is not None
                               and hooks.guest_crash()))
        else:
            # SharedCache admission metadata, derived per GET *ordinal*
            # from hint × effective-profile agreement: `hinted` marks
            # GETs promoted at ingress (the DES's `prefetchable` bit —
            # the two executors must agree on it for hit/miss parity);
            # `cacheable` is the per-GET bypass (declared
            # Get.cacheable=False or the event's `"cache": false`
            # header). Flags are queued per (bucket, key) in declared
            # order and consumed per occurrence — a set keyed on the
            # pair would collapse duplicate-key GETs with differing
            # flags into one decision and diverge from the DES's
            # per-op admission.
            gets = profile.gets if profile is not None else ()
            admission: dict[tuple[str, str], list] = {}
            for h, g in zip(ctx.inputs, gets):
                admission.setdefault((h.bucket, h.key), []).append(
                    (g.prefetchable, g.cacheable and h.cacheable))
            ctx.gctx = GuestContext(tenant=ctx.w.name,
                                    cred_handle=self._creds[ctx.w.name],
                                    invocation_id=ctx.inv_id,
                                    admission=admission)
            ctx.client = NexusClient(
                ctx.gctx, lambda: self.supervisor.backend, self.acct,
                max_retries=self.client_max_retries,
                ack_timeout_s=self.writeback_ack_timeout_s,
                retry=self._retry_spec, breaker=self.guard.breaker,
                prefetch_timeout_s=self.connect_timeout_s)

    # --------------------------------------------------------- group actions
    #
    # Platform groups (restore/rpc_in/connect/reply) act; guest groups
    # (fetch/compute/write) OBSERVE the handler — except the first
    # hinted GET, whose prefetch the platform itself launches at
    # ingress (§4.2.2). Which is which comes from the plan + profile,
    # never from per-variant branches.

    def _build_actions(self, plan: PhasePlan, guest: _GuestRun) -> dict:
        actions = {
            "restore": self._act_restore,
            "rpc_in": self._act_rpc_in,
            "connect": self._act_connect,
            "reply": self._act_reply,
        }
        for g in plan.group_names():
            if g in actions:
                continue
            if g.startswith("fetch[") and \
                    int(g[len("fetch["):-1]) == guest.prefetch_op:
                actions[g] = self._make_prefetch_action(guest.prefetch_op)
            elif g.startswith("write["):
                actions[g] = self._make_write_action(int(g[len("write["):-1]),
                                                     g)
            else:                        # guest-driven fetch/compute
                actions[g] = (lambda inv, _g=g: inv.guest.await_group(_g))
        return actions

    def _make_prefetch_action(self, i: int):
        def act(inv: _Invocation) -> None:
            handle = self.backend.prefetch(
                inv.w.name, self._creds[inv.w.name], inv.inputs[i])
            inv.guest.set_prefetch(handle)
            handle.wait(timeout=self.connect_timeout_s)
        return act

    def _make_write_action(self, k: int, group: str):
        def act(inv: _Invocation) -> None:
            inv.guest.await_group(group)     # handed off (async) or acked
            ticket = inv.guest.tickets.get(k)
            if ticket is not None:
                # the VM may already be released at the plan's barrier;
                # the group (and the response) still gates on the ack.
                # A lost ack is re-driven idempotently (§5) — the
                # client's wait resolves it from the dedup record.
                inv.guest.etags[k] = inv.client.wait_ack(
                    ticket, self.writeback_ack_timeout_s)
        return act

    def _act_restore(self, ctx: _Invocation) -> None:
        ctx.inst, ctx.cold = self._pools[ctx.w.name].acquire()
        if ctx.cold and not ctx.cold_expected and self.spec.offload_sdk:
            # a racing invocation stole the predicted warm instance, so
            # this one restored fresh under the warm plan (no connect
            # phase): pay the per-VM connection setup here, serially —
            # conservative, and the VM never runs without its storage
            # connections.
            self.backend.connection_setup(f"{ctx.w.name}#vm-{ctx.inv_id}")

    def _act_rpc_in(self, ctx: _Invocation) -> None:
        spec = self.spec
        if spec.offload_rpc:
            self.backend.terminate_rpc()        # backend-native (§4.2.1)
        elif spec.virtualized:
            F.rpc_ingress_cost(in_guest=True).charge(self.acct)
        else:
            # wasm: Faabric scheduler hop + sandbox-bootstrap page faults
            self.acct.charge(M.HOST_KERNEL, F.FAABRIC_KERNEL_MCYC)
            time.sleep(spec.dispatch_s)

    def _act_connect(self, ctx: _Invocation) -> None:
        # per-VM storage connection setup (the 'Add Server' cold-start
        # term) — a cold-plan-only phase, overlapped with the restore
        # and serialized before the first fetch by the plan's edges.
        self.backend.connection_setup(f"{ctx.w.name}#vm-{ctx.inv_id}")

    def _act_reply(self, ctx: _Invocation) -> None:
        if not self.spec.virtualized:
            return                     # folded into the dispatch hop
        F.rpc_ingress_cost(in_guest=not self.spec.offload_rpc,
                           nbytes=1024).charge(self.acct)

    # ------------------------------------------------------- drain / teardown

    def drain(self, timeout_s: float | None = None) -> None:
        """Graceful quiesce: stop admitting (new `invoke`s raise typed
        `Rejected("drain")`), then wait for every in-flight invocation
        to finish. Async write chains are covered — each invocation's
        write groups gate its response on the durable ack, so
        ``inflight == 0`` implies every chain is flushed. The node can
        then be handed off / restarted; `resume()` reopens admission.
        Raises `TimeoutError` if in-flight work outlives `timeout_s`.
        """
        self.guard.begin_drain()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._quiesce:
            while self._inflight > 0:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0.0:
                    raise TimeoutError(
                        f"drain: {self._inflight} invocations still "
                        f"in flight after {timeout_s}s")
                self._quiesce.wait(left)

    def resume(self) -> None:
        """Reopen admission after a `drain()`."""
        self.guard.end_drain()

    def shutdown(self) -> None:
        self._ingress.shutdown(wait=True)
        if self.supervisor:
            self.supervisor.stop()
