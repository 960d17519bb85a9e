"""Invocation PhasePlan: one declarative cost model for both executors.

The paper's core claim (§4.2, §7) is that Nexus's wins come from
*structural* differences in where invocation phases run and what
overlaps. This module makes those structures **data**: a `SystemSpec`
plus a workload's declared `IOProfile` compile into a `PhasePlan` — a
DAG of phases with resource tags and release/response barriers — and
the two executors merely *interpret* that graph:

* `runtime.WorkerNode` maps phases onto real threads and backend calls
  (real bytes, real arenas, real crash injection) — the handler issues
  its own client calls and the plan walker *observes* them;
* `des.DensitySimulator` walks the identical graph in virtual time with
  `CorePool` contention.

"Prefetch overlaps restore" and "async writeback releases the VM before
the ack" are edges and barriers here — not control flow in two
executors. Adding a system variant means adding a `SystemSpec` entry;
adding an I/O shape means declaring an `IOProfile`.

Phases (paper §4.2 anatomy of an invocation), per-op indexed:

    restore       — snapshot restore / sandbox bootstrap (0 when warm)
    rpc_in        — invocation RPC termination (guest gRPC vs native)
    connect       — per-VM storage connection setup (cold; 'Add Server')
    fetch_cpu[i]  — input fabric cycles for GET i (SDK + stub + transport)
    fetch_net[i]  — GET i wire time
    compute[j]    — handler compute segment j on the instance vCPU
    write_cpu[k]  — output fabric cycles for PUT k
    write_net[k]  — PUT k wire time
    reply         — response RPC egress

Resource tags say what a phase consumes:

    guest_core     — one worker-node core for the duration
    backend_worker — a backend connection-pool slot *and* a core (the
                     shared daemon's work contends on the same cores)
    wire           — pure latency (network / handshake wait)
    none           — pure latency off every resource (scheduler hops)

Structural rules (each a paper mechanism, applied as data):

* only the *first* hinted GET prefetches at ingress (§4.2.2): its
  fetch chain omits the restore edge; every other I/O op follows the
  handler's program order through the guest;
* a synchronous PUT blocks the guest until the ack; under async
  writeback the guest continues, the write chain floats, and the
  release barrier moves to the last compute segment (§4.2.5) while the
  response still gates on *every* durable PUT;
* cold starts on an offloaded fabric first establish the new VM's
  storage connections — serial with the first fetch, overlapped with
  the restore (§4.2.4, Fig 12 'Add Server').

A copy of ``repro.core.plan``, whole.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache

from repro_torch.core import fabric as F
from repro_torch.core.transport import TRANSPORTS
from repro_torch.core.workloads import IOProfile, Workload

MB = 1024 * 1024

# ------------------------------------------------------------ resource tags

GUEST_CORE = "guest_core"
BACKEND_WORKER = "backend_worker"
WIRE = "wire"
NONE = "none"

RESOURCES = (GUEST_CORE, BACKEND_WORKER, WIRE, NONE)

#: canonical phase base -> breakdown group base (the *_cpu/*_net split
#: only exists where time is virtual; the threaded runtime reports at
#: group granularity).
_GROUP_BASE = {"fetch_cpu": "fetch", "fetch_net": "fetch",
               "write_cpu": "write", "write_net": "write"}


def phase_group(name: str) -> str:
    """Breakdown group of a phase: ``fetch_cpu[2]`` -> ``fetch[2]``."""
    base, bracket, idx = name.partition("[")
    g = _GROUP_BASE.get(base, base)
    return g + bracket + idx


# -------------------------------------------------------------- system spec

@dataclass(frozen=True)
class SystemSpec:
    """A system variant as pure data — the only thing a new variant adds.

    The four paper systems + the memory-figure sdk-only point, plus:
    * ``nexus-prefetch-only`` — hinted prefetch without async writeback
      (isolates §4.2.2 from §4.2.5);
    * ``wasm`` — Faasm-style reference point (paper Fig 14): no guest OS,
      no virtualization boundary, fabric compiled in-process, sandbox
      scheduler hop instead of an RPC server.
    """

    name: str
    offload_sdk: bool = False        # storage fabric in the shared backend
    offload_rpc: bool = False        # invocation RPC terminated natively
    prefetch: bool = False           # hinted input prefetch overlaps restore
    async_writeback: bool = False    # output write releases the VM early
    transport: str = "tcp"           # bulk transport: 'tcp' | 'rdma'
    virtualized: bool = True         # False => no VM boundary (wasm)
    sdk: str = "aws"                 # storage SDK cost class (fabric table)
    guest_lang: str = "py"           # language cost class of in-guest code
    compute_scale: float = 1.0       # handler speed vs Python reference
    dispatch_s: float = 0.0          # per-invocation scheduler hop (wasm)
    mem_variant: str | None = None   # fabric.instance_memory key override

    @property
    def coupled(self) -> bool:
        return not self.offload_sdk

    @property
    def memory_variant(self) -> str:
        if self.mem_variant is not None:
            return self.mem_variant
        if not self.offload_sdk:
            return "baseline"
        if not self.offload_rpc:
            return "nexus-sdk-only"
        return "nexus"


SYSTEMS: dict[str, SystemSpec] = {s.name: s for s in [
    SystemSpec("baseline"),
    SystemSpec("nexus-tcp", offload_sdk=True, offload_rpc=True),
    SystemSpec("nexus-async", offload_sdk=True, offload_rpc=True,
               prefetch=True, async_writeback=True),
    SystemSpec("nexus", offload_sdk=True, offload_rpc=True,
               prefetch=True, async_writeback=True, transport="rdma"),
    # memory-figure-only variant (Fig 3): SDK offloaded, RPC kept in guest
    SystemSpec("nexus-sdk-only", offload_sdk=True, offload_rpc=False),
    # prefetch without early release: isolates §4.2.2 from §4.2.5
    SystemSpec("nexus-prefetch-only", offload_sdk=True, offload_rpc=True,
               prefetch=True, async_writeback=False),
    # Faasm-style WASM point (Fig 14): in-process C++-class fabric, no VM
    # boundary, Faabric scheduler hop; paper claims Nexus lands within
    # ~20-25% of its cycle cost at full ecosystem compatibility.
    SystemSpec("wasm", virtualized=False, sdk="minio", guest_lang="go",
               compute_scale=F.WASM_COMPUTE_SCALE,
               dispatch_s=F.SANDBOX_DISPATCH_S, mem_variant="wasm"),
]}


# -------------------------------------------------------------- phase graph

@dataclass(frozen=True)
class Phase:
    name: str
    resource: str
    after: tuple[str, ...] = ()
    backend_group: str | None = None     # backend slot held across group


@dataclass(frozen=True)
class PhasePlan:
    """Compiled, validated phase DAG for one (SystemSpec, shape, cold)."""

    system: str
    cold: bool
    phases: tuple[Phase, ...]
    release_after: str                   # phase completing -> release VM
    respond_after: str                   # phase completing -> respond
    _by_name: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_by_name",
                           {p.name: p for p in self.phases})
        self._validate()
        # memoize the graph queries once, at construction: plans are
        # compile-cached and immutable, yet successors()/ancestors()/
        # backend_groups() used to re-scan all phases (O(V) / O(V*E))
        # on every call — validation, tests, and goldens paid that
        # repeatedly even after the hot path moved to PlanProgram.
        succs: dict[str, list[str]] = {p.name: [] for p in self.phases}
        anc: dict[str, frozenset[str]] = {}
        for p in self.phases:            # declaration order is topological
            for d in p.after:
                succs[d].append(p.name)
            anc[p.name] = frozenset(p.after).union(*(anc[d] for d in p.after))
        object.__setattr__(self, "_succs",
                           {n: tuple(v) for n, v in succs.items()})
        object.__setattr__(self, "_anc", anc)
        groups: dict[str, list[str]] = {}
        for p in self.phases:
            if p.backend_group:
                groups.setdefault(p.backend_group, []).append(p.name)
        object.__setattr__(self, "_groups",
                           {g: tuple(v) for g, v in groups.items()})

    # ------------------------------------------------------------ queries

    def phase(self, name: str) -> Phase:
        return self._by_name[name]

    @property
    def phase_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.phases)

    def successors(self, name: str) -> tuple[str, ...]:
        """Direct successors in declaration (topological) order — O(1),
        precomputed in `__post_init__`."""
        return self._succs[name]

    def topo_order(self) -> tuple[str, ...]:
        """Deterministic topological order (declaration order is one)."""
        return self.phase_names

    def ancestors(self, name: str) -> frozenset[str]:
        """All phases `name` transitively depends on — O(1), memoized."""
        return self._anc[name]

    def backend_groups(self) -> dict[str, tuple[str, ...]]:
        """group -> its phases in topological order (memoized; treat as
        read-only)."""
        return self._groups

    def slot_release_phase(self, group: str, kernel_bypass: bool) -> str:
        """Where a backend group's connection-pool slot is released:
        after its last CPU slice under kernel-bypass (completion-driven),
        after the wire completes under TCP (the goroutine blocks)."""
        members = self.backend_groups()[group]
        if kernel_bypass:
            cpu = [n for n in members
                   if self.phase(n).resource == BACKEND_WORKER]
            if cpu:
                return cpu[-1]
        return members[-1]

    # ------------------------------------------------- breakdown groups

    def groups(self) -> tuple[tuple[str, tuple[str, ...]], ...]:
        """Breakdown groups in topological order: (group, phases).
        The threaded runtime executes/reports at this granularity."""
        out: list[tuple[str, list[str]]] = []
        for p in self.phases:
            g = phase_group(p.name)
            if out and out[-1][0] == g:
                out[-1][1].append(p.name)
            else:
                out.append((g, [p.name]))
        return tuple((g, tuple(v)) for g, v in out)

    def group_names(self) -> tuple[str, ...]:
        return tuple(g for g, _ in self.groups())

    def group_deps(self) -> dict[str, tuple[str, ...]]:
        """Dependency edges lifted to breakdown-group granularity."""
        owner = {}
        for g, members in self.groups():
            for m in members:
                owner[m] = g
        deps: dict[str, set] = {g: set() for g, _ in self.groups()}
        for p in self.phases:
            for dep in p.after:
                if owner[dep] != owner[p.name]:
                    deps[owner[p.name]].add(owner[dep])
        return {g: tuple(sorted(v)) for g, v in deps.items()}

    @property
    def release_group(self) -> str:
        return phase_group(self.release_after)

    @property
    def respond_group(self) -> str:
        return phase_group(self.respond_after)

    # ----------------------------------------------------------- analysis

    def critical_path(self, durations: dict[str, float]) -> float:
        """Longest path through the DAG — the zero-contention latency.
        `unloaded_latency` in the density simulator is this, warm."""
        finish: dict[str, float] = {}
        for p in self.phases:             # phases are topologically sorted
            start = max((finish[d] for d in p.after), default=0.0)
            finish[p.name] = start + durations.get(p.name, 0.0)
        return max(finish.values()) if finish else 0.0

    # --------------------------------------------------------- validation

    def _validate(self) -> None:
        names = set()
        for p in self.phases:
            if p.name in names:
                raise ValueError(f"{self.system}: duplicate phase {p.name}")
            if p.resource not in RESOURCES:
                raise ValueError(f"{self.system}: bad resource "
                                 f"{p.resource!r} on {p.name}")
            for dep in p.after:
                if dep not in names:     # deps must precede: topo by decl
                    raise ValueError(
                        f"{self.system}: phase {p.name!r} depends on "
                        f"{dep!r} which is absent or declared later")
            names.add(p.name)
        for barrier in (self.release_after, self.respond_after):
            if barrier not in names:
                raise ValueError(f"{self.system}: barrier on unknown "
                                 f"phase {barrier!r}")
        seen_groups = set()
        for g, _ in self.groups():
            if g in seen_groups:          # groups must be contiguous runs
                raise ValueError(f"{self.system}: breakdown group {g!r} "
                                 f"is not contiguous")
            seen_groups.add(g)


# ---------------------------------------------------------------- compiler

#: the classic FaaS shape, used when no profile is supplied.
DEFAULT_PROFILE = IOProfile.single(1.0, 1.0, 50.0)


def compile_plan(spec: SystemSpec, profile: IOProfile | None = None,
                 cold: bool = True) -> PhasePlan:
    """Compile (SystemSpec, IOProfile, cold) into a PhasePlan.

    Cached on the profile's size-free *shape*: every workload with the
    same op structure — and both executors — interpret the same object.
    """
    shape = (profile if profile is not None else DEFAULT_PROFILE).shape
    return _compile_plan(spec, shape, bool(cold))


def _reduced(deps: set[str], anc: dict[str, set[str]]) -> tuple[str, ...]:
    """Transitive reduction of a dep set: drop edges implied by others
    (keeps the golden graphs minimal and the group DAG readable)."""
    keep = [d for d in deps
            if not any(d in anc[e] for e in deps if e != d)]
    return tuple(sorted(keep))


@lru_cache(maxsize=None)
def _compile_plan(spec: SystemSpec, shape: tuple, cold: bool) -> PhasePlan:
    if (spec.prefetch or spec.async_writeback) and not spec.offload_sdk:
        raise ValueError(
            f"{spec.name}: prefetch/async writeback are backend "
            f"mechanisms — they require offload_sdk=True")
    has_connect = cold and spec.offload_sdk
    offl = spec.offload_sdk

    phases: list[Phase] = []
    anc: dict[str, set[str]] = {}

    def add(name, resource, deps=(), group=None):
        after = _reduced(set(deps), anc)
        anc[name] = set(after).union(*(anc[d] for d in after))
        phases.append(Phase(name, resource, after=after,
                            backend_group=group))

    add("restore", GUEST_CORE)
    add("rpc_in", GUEST_CORE if spec.virtualized else NONE,
        ("restore",) if not spec.offload_rpc else ())
    if has_connect:
        add("connect", WIRE, ("rpc_in",))

    first_storage = next((i for i, op in enumerate(shape)
                          if op[0] in ("get", "put")), None)
    #: the guest's program counter: what the next guest-issued phase
    #: must wait on (rpc_in delivered the event; restore joins per-op).
    prev: set[str] = {"rpc_in"}
    gi = ci = pi = 0
    writes: list[str] = []
    for oi, op in enumerate(shape):
        first_conn = ("connect",) if has_connect and oi == first_storage \
            else ()
        if op[0] == "get":
            cpu, net = f"fetch_cpu[{gi}]", f"fetch_net[{gi}]"
            grp = f"fetch[{gi}]" if offl else None
            if spec.prefetch and op[1]:
                # hinted ingress prefetch: the fetch chain starts before
                # the VM is up and joins the guest at the next phase
                add(cpu, BACKEND_WORKER if offl else GUEST_CORE,
                    {"rpc_in", *first_conn}, grp)
                add(net, WIRE, (cpu,), grp)
                prev = prev | {net, "restore"}
            else:
                add(cpu, BACKEND_WORKER if offl else GUEST_CORE,
                    prev | {"restore", *first_conn}, grp)
                add(net, WIRE, (cpu,), grp)
                prev = {net}               # the guest blocks on the data
            gi += 1
        elif op[0] == "compute":
            name = f"compute[{ci}]"
            add(name, GUEST_CORE, prev | {"restore"})
            prev = {name}
            ci += 1
        else:                              # put
            cpu, net = f"write_cpu[{pi}]", f"write_net[{pi}]"
            grp = f"write[{pi}]" if offl else None
            add(cpu, BACKEND_WORKER if offl else GUEST_CORE,
                prev | {"restore", *first_conn}, grp)
            add(net, WIRE, (cpu,), grp)
            writes.append(net)
            if not spec.async_writeback:
                prev = {net}               # the guest blocks on the ack
            pi += 1

    # the response gates on the guest finishing AND every durable PUT
    add("reply", GUEST_CORE if spec.virtualized else NONE,
        prev | set(writes))
    # async writeback releases the instance at the guest's FINAL program
    # point (§4.2.5) — the last phase the guest thread blocks on, which
    # is the last compute segment only when no guest-blocking I/O
    # follows it. The release phase must postdate the restore (the
    # instance must exist to be released); profiles whose final guest
    # op precedes that join release at the reply like sync variants.
    release = "reply"
    if spec.async_writeback:
        order = {ph.name: i for i, ph in enumerate(phases)}
        cands = [d for d in prev if d not in ("restore", "rpc_in")]
        if cands:
            last = max(cands, key=order.__getitem__)
            if "restore" in anc[last]:
                release = last
    return PhasePlan(
        system=spec.name, cold=cold, phases=tuple(phases),
        release_after=release, respond_after="reply")


# ------------------------------------------------------- program lowering

@dataclass(frozen=True, eq=False)
class PlanProgram:
    """Flat, integer-indexed lowering of one compiled `PhasePlan`.

    `PhasePlan` is the *authoring* representation: named phases, string
    edges, validation, golden-friendly queries. Interpreting it per
    invocation made the DES hot path walk dicts of names and rebuild
    closure graphs millions of times. A PlanProgram is the *execution*
    representation: every phase is an integer index, every lookup an
    array access —

    * ``succ[i]``        — successor indices (declaration order);
    * ``indegree[i]``    — dependency count (per-invocation state is a
                           countdown copy of this vector);
    * ``on_core[i]``     — phase occupies a node core (guest_core or
                           backend_worker) vs pure latency (wire/none);
    * ``acquires_slot`` / ``releases_slot`` — where a backend group's
      connection-pool slot is taken and dropped (the release point
      depends on the transport's kernel-bypass rule, so the lowering is
      cached per (plan, kernel_bypass));
    * ``release_idx`` / ``respond_idx`` — the plan's barriers, as indices;
    * ``group_*``        — the same lowering at breakdown-group
      granularity, which the threaded `runtime._PlanRun` walker drives
      off (one lowered representation, two executors — they cannot
      drift).

    A duration *vector* aligned with ``names`` (`duration_vector`)
    replaces the per-phase dict lookups of `phase_durations`.
    """

    plan: PhasePlan
    kernel_bypass: bool
    names: tuple[str, ...]
    on_core: tuple[bool, ...]
    succ: tuple[tuple[int, ...], ...]
    #: cohort-friendly layout (the vectorized hot path consumes these):
    #: predecessors per phase, plus the successor lists flattened to a
    #: CSR pair — ``succ_flat[succ_off[i]:succ_off[i+1]]`` — so a batch
    #: of same-instant completions walks one flat integer array instead
    #: of nested tuples.
    pred: tuple[tuple[int, ...], ...]
    succ_flat: tuple[int, ...]
    succ_off: tuple[int, ...]
    indegree: tuple[int, ...]
    roots: tuple[int, ...]
    acquires_slot: tuple[bool, ...]
    releases_slot: tuple[bool, ...]
    release_idx: int
    respond_idx: int
    # breakdown-group granularity (the threaded walker's unit of work)
    group_names: tuple[str, ...]
    group_succ: tuple[tuple[int, ...], ...]
    group_indegree: tuple[int, ...]
    group_roots: tuple[int, ...]
    # ---- FaultPlane lowering (des faulted interpreter, core/faults.py)
    #: phase executes fabric work (fetch/write/connect chains) — the
    #: blast radius of a fabric crash: under an offloaded SDK these run
    #: in the shared backend (abort + re-queue behind the restart), in
    #: a coupled design they run inside the guest (the crash kills the
    #: whole invocation)
    fabric: tuple[bool, ...]
    #: backend-group ordinal per phase (-1: none) and each ordinal's
    #: head phase index + member list — crash recovery re-drives an
    #: aborted group from its head
    bgroup_of: tuple[int, ...]
    bgroup_head: tuple[int, ...]
    bgroup_members: tuple[tuple[int, ...], ...]
    #: logical-PUT ordinal completed by this phase (-1: none) — the
    #: chaos ledger's exactly-once unit
    put_ordinal: tuple[int, ...]
    restore_idx: int

    @property
    def n_phases(self) -> int:
        return len(self.names)


def lower_program(plan: PhasePlan, kernel_bypass: bool = False) -> PlanProgram:
    """Lower a validated PhasePlan into its flat PlanProgram."""
    names = plan.phase_names
    idx = {n: i for i, n in enumerate(names)}
    groups = plan.backend_groups()
    heads = {members[0] for members in groups.values()}
    slot_rel = {plan.slot_release_phase(g, kernel_bypass) for g in groups}

    gnames = plan.group_names()
    gidx = {g: i for i, g in enumerate(gnames)}
    gdeps = plan.group_deps()
    gsucc: list[list[int]] = [[] for _ in gnames]
    for g, ds in gdeps.items():
        for d in ds:
            gsucc[gidx[d]].append(gidx[g])

    # FaultPlane lowering: fabric mask, backend-group geometry, logical
    # PUT ordinals (see the PlanProgram field docs). `connect` is NOT
    # fabric: threaded connection setup never traverses RemoteStorage,
    # so storage fault windows must not touch it in the DES either —
    # one fault surface, two executors.
    fabric_bases = ("fetch_cpu", "fetch_net", "write_cpu", "write_net")
    base = [n.partition("[")[0] for n in names]
    ordinals = [n.partition("[")[2].rstrip("]") for n in names]
    bg_names = sorted(groups, key=lambda g: idx[groups[g][0]])
    bg_ord = {g: i for i, g in enumerate(bg_names)}
    bgroup_of = tuple(bg_ord[p.backend_group] if p.backend_group else -1
                      for p in plan.phases)
    bgroup_members = tuple(tuple(idx[m] for m in groups[g])
                           for g in bg_names)
    bgroup_head = tuple(bgroup_members[o][0] if o >= 0 else -1
                        for o in bgroup_of)

    succ = tuple(tuple(idx[s] for s in plan.successors(n)) for n in names)
    succ_off: list[int] = [0]
    succ_flat: list[int] = []
    for row in succ:
        succ_flat.extend(row)
        succ_off.append(len(succ_flat))

    return PlanProgram(
        plan=plan, kernel_bypass=kernel_bypass,
        names=names,
        on_core=tuple(p.resource in (GUEST_CORE, BACKEND_WORKER)
                      for p in plan.phases),
        succ=succ,
        pred=tuple(tuple(idx[d] for d in p.after) for p in plan.phases),
        succ_flat=tuple(succ_flat),
        succ_off=tuple(succ_off),
        indegree=tuple(len(p.after) for p in plan.phases),
        roots=tuple(i for i, p in enumerate(plan.phases) if not p.after),
        acquires_slot=tuple(n in heads for n in names),
        releases_slot=tuple(n in slot_rel for n in names),
        release_idx=idx[plan.release_after],
        respond_idx=idx[plan.respond_after],
        group_names=gnames,
        group_succ=tuple(tuple(sorted(s)) for s in gsucc),
        group_indegree=tuple(len(gdeps[g]) for g in gnames),
        group_roots=tuple(i for i, g in enumerate(gnames) if not gdeps[g]),
        fabric=tuple(b in fabric_bases for b in base),
        bgroup_of=bgroup_of,
        bgroup_head=bgroup_head,
        bgroup_members=bgroup_members,
        put_ordinal=tuple(int(o) if b == "write_net" else -1
                          for b, o in zip(base, ordinals)),
        restore_idx=names.index("restore"),
    )


def compile_program(spec: SystemSpec, profile: IOProfile | None = None,
                    cold: bool = True, *,
                    kernel_bypass: bool = False) -> PlanProgram:
    """Compile-and-lower, cached beside the plan cache on the same
    size-free shape key (+ the transport's kernel-bypass rule)."""
    shape = (profile if profile is not None else DEFAULT_PROFILE).shape
    return _compile_program(spec, shape, bool(cold), bool(kernel_bypass))


#: Debug-mode hook: when enabled, every *newly* lowered program runs
#: the full `analysis.verify` invariant pass before it enters the
#: compile cache. Off by default: per-process re-verification is a
#: debugging aid, not a correctness dependency. Seeded from the
#: NEXUS_VERIFY_PLANS environment variable so CI and repro runs can
#: flip it without touching code.
_verify_on_compile = os.environ.get("NEXUS_VERIFY_PLANS", "") not in ("", "0")


def set_verify_on_compile(enabled: bool) -> bool:
    """Toggle verify-on-compile; returns the previous setting.

    Enabling also clears the program compile cache: cached programs
    were admitted under the old policy, and the lru key can't see the
    flag — without the clear, a warm process would silently skip
    verification for every shape it already compiled.
    """
    global _verify_on_compile
    prev = _verify_on_compile
    _verify_on_compile = bool(enabled)
    if enabled and not prev:
        _compile_program.cache_clear()
    return prev


def verify_on_compile() -> bool:
    return _verify_on_compile


@lru_cache(maxsize=None)
def _compile_program(spec: SystemSpec, shape: tuple, cold: bool,
                     kernel_bypass: bool) -> PlanProgram:
    prog = lower_program(_compile_plan(spec, shape, cold), kernel_bypass)
    if _verify_on_compile:
        # late import: analysis sits above plan in the layering
        from repro_torch.core.analysis.verify import verify_program
        verify_program(prog)
    return prog


# -------------------------------------------------------------- cost model

def _cpu_s(mcycles: float) -> float:
    return mcycles / F.GHZ_MCYC_PER_S


def _transport_cpu_s(spec: SystemSpec, nbytes: int) -> float:
    tr = TRANSPORTS[spec.transport]
    mb = nbytes / MB
    return _cpu_s(tr.host_kernel_mcyc_per_mb * mb
                  + tr.host_kernel_mcyc_per_msg
                  + tr.host_user_mcyc_per_mb * mb)


def _op_cpu_s(spec: SystemSpec, nbytes: int) -> float:
    """Fabric CPU seconds for one GET/PUT of nbytes under `spec`."""
    if spec.offload_sdk:
        fabric = F.remoted_op_cost(spec.sdk, nbytes).total()
    elif spec.virtualized:
        fabric = F.in_guest_op_cost(spec.sdk, spec.guest_lang, nbytes).total()
    else:                                # wasm: fabric compiled in-process
        fabric = F.in_process_op_cost(spec.sdk, spec.guest_lang,
                                      nbytes).total()
    return _cpu_s(fabric) + _transport_cpu_s(spec, nbytes)


def _rpc_cpu_s(spec: SystemSpec, nbytes: int = 4096) -> float:
    if not spec.virtualized:
        return 0.0                       # folded into the dispatch hop
    return _cpu_s(F.rpc_ingress_cost(not spec.offload_rpc, nbytes).total())


def phase_durations(spec: SystemSpec, w: Workload,
                    cold: bool) -> dict[str, float]:
    """Modeled duration (seconds) of every phase in
    `compile_plan(spec, w.profile, cold)` — the single cost model the
    density simulator executes and the SLO denominator derives from."""
    tr = TRANSPORTS[spec.transport]
    mem = F.instance_memory(w.extra_libs_mb, spec.memory_variant)
    d = {
        "restore": (F.restore_seconds_components(mem) if cold else 0.0),
        "rpc_in": spec.dispatch_s + _rpc_cpu_s(spec),
        "reply": _rpc_cpu_s(spec, 1024),
    }
    if cold and spec.offload_sdk:
        d["connect"] = tr.setup_latency_s
    for i, g in enumerate(w.profile.gets):
        d[f"fetch_cpu[{i}]"] = _op_cpu_s(spec, g.size_bytes)
        d[f"fetch_net[{i}]"] = tr.transfer_latency(g.size_bytes)
    for j, seg in enumerate(w.profile.segments):
        d[f"compute[{j}]"] = _cpu_s(seg.mcycles * spec.compute_scale)
    for k, p in enumerate(w.profile.puts):
        d[f"write_cpu[{k}]"] = _op_cpu_s(spec, p.size_bytes)
        d[f"write_net[{k}]"] = tr.transfer_latency(p.size_bytes)
    return d


def duration_vector(spec: SystemSpec, w: Workload,
                    cold: bool) -> tuple[float, ...]:
    """`phase_durations` as a vector aligned with the compiled plan's
    phase order (== the PlanProgram's index space): the hot path reads
    ``durs[i]`` instead of hashing phase-name strings."""
    p = compile_plan(spec, w.profile, cold=cold)
    d = phase_durations(spec, w, cold)
    return tuple(d.get(n, 0.0) for n in p.phase_names)


def cache_vector(names: tuple[str, ...]) -> tuple[int, ...]:
    """Per-phase GET ordinal eligible for SharedCache service, aligned
    with a program's phase index space: ``fetch_net[i]`` maps to ``i``,
    every other phase to ``-1``. The DES cache overlay and PlanVerify's
    overlay check both re-derive eligibility from this one mapping."""
    out = []
    for n in names:
        base, _, idx = n.partition("[")
        out.append(int(idx.rstrip("]")) if base == "fetch_net" else -1)
    return tuple(out)


def unloaded_latency(spec: SystemSpec, w: Workload) -> float:
    """Warm, zero-contention critical path (the paper's SLO denominator)
    — by construction the warm plan's critical path."""
    return compile_plan(spec, w.profile, cold=False).critical_path(
        phase_durations(spec, w, cold=False))
