"""ClusterSim — fleet-scale dispatch over per-node density simulators.

The paper measures Nexus's density and latency wins on one node; the
fleet question (ROADMAP item 1) is how those wins compound when a
frontend spreads millions of invocations over hundreds of heterogeneous
nodes. This module keeps the repo's policy-as-data discipline:

* `NodeSpec` / `ClusterSpec` — pure data, like `SystemSpec`,
  `FaultSchedule` and `GuardrailPolicy`: N heterogeneous node groups,
  each a system variant + capacity + optional per-node guardrail
  policy / fault schedule, plus node add (`up_at_s`) and drain
  (`DrainWindow`) instants driven by the existing machinery.
* `DispatchPolicy` — a frozen strategy value (random, round-robin,
  least-loaded, JBSQ, function-affinity) interpreted by the simulator;
  every policy is a pure function of (spec, seed).
* `ClusterSimulator` — ONE frontend arrival stream (the same
  `sample_rates` + `generate_arrivals` + `merge_streams` pipeline a
  single `DensitySimulator` uses) routed through the dispatch policy
  into per-node `DensitySimulator`s that all share ONE `EventLoop` /
  virtual clock. Members run the PR-6 hot/calendar engines unchanged:
  hot records carry their owning sim (`_R_OWN`/`_C_OWN`) and the
  cluster's loop routes each event home.
* `ClusterResult` — fleet goodput, per-node utilization and dispatch
  counts, merged p50/p99, typed shed counts.

Differential anchor: a 1-node `ClusterSpec` under the trivial
(`single`) policy is bit-for-bit identical to a standalone
`DensitySimulator` — same arrival stream, same (t, seq) event order,
same IEEE latency floats — pinned by the `cluster1/...` entry in
`tests/goldens/des_parity.json`.

A copy of ``repro.core.cluster``, whole. Every constant keeps the
reference's value. Its members are the port's `DensitySimulator`s, and
the owner slots the shared loop routes through (`_R_OWN`, `_C_OWN`,
`_CRUN`) are the port's ``des``'s.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field

from repro_torch.core import faults as FA
from repro_torch.core import guardrails as GR
from repro_torch.core import workloads as W
from repro_torch.core.cache import CacheSpec
from repro_torch.core.des import (_C_OWN, _CRUN, _ENGINE_ALIASES, _R_OWN,
                                  CalendarQueue, DensitySimulator, EventLoop,
                                  SimResult)
from repro_torch.core.plan import SYSTEMS
from repro_torch.core.trace import (generate_arrivals, merge_streams,
                                    sample_rates)

# ------------------------------------------------------------- dispatch

POLICY_KINDS = ("single", "random", "round_robin", "least_loaded",
                "jbsq", "affinity")


@dataclass(frozen=True)
class DispatchPolicy:
    """One frontend placement strategy as a value.

    * ``single``       — everything to the first eligible node (the
                         trivial policy the 1-node parity golden pins).
    * ``random``       — seeded uniform choice over eligible nodes.
    * ``round_robin``  — global arrival counter modulo the eligible set.
    * ``least_loaded`` — smallest in-flight / total-cores ratio
                         (capacity-aware on heterogeneous fleets).
    * ``jbsq``         — join-bounded-shortest-queue: smallest raw
                         in-flight count, preferring nodes below
                         ``bound`` (Hnefi/p3's JBSQ(d) shape).
    * ``affinity``     — keep-alive-aware: prefer nodes holding a warm
                         idle instance of the function (Faasm-style
                         locality), falling back to shortest queue.

    All six are deterministic given (ClusterSpec, seed): ties break on
    the lowest node index, and ``random`` draws from a seeded PRNG.
    """

    name: str
    kind: str
    bound: int = 4          # JBSQ depth bound

    def __post_init__(self):
        if self.kind not in POLICY_KINDS:
            raise ValueError(f"unknown dispatch kind {self.kind!r}")
        if self.bound < 1:
            raise ValueError("bound must be >= 1")


DISPATCH_POLICIES: dict[str, DispatchPolicy] = {p.name: p for p in (
    DispatchPolicy("single", kind="single"),
    DispatchPolicy("random", kind="random"),
    DispatchPolicy("round_robin", kind="round_robin"),
    DispatchPolicy("least_loaded", kind="least_loaded"),
    DispatchPolicy("jbsq", kind="jbsq", bound=4),
    DispatchPolicy("affinity", kind="affinity"),
)}


def resolve_policy(policy: str | DispatchPolicy) -> DispatchPolicy:
    if isinstance(policy, DispatchPolicy):
        return policy
    try:
        return DISPATCH_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown dispatch policy {policy!r} "
            f"(have {', '.join(sorted(DISPATCH_POLICIES))})") from None


# ------------------------------------------------------------ spec data


@dataclass(frozen=True)
class NodeSpec:
    """One dispatch target (times ``count``): a system variant plus its
    capacity. ``nodes`` is the member's internal worker-box count (a
    member can be a multi-box micro-cluster; the standalone
    `DensitySimulator` default is 4). Lifecycle: the member joins the
    fleet at ``up_at_s`` (node add) and is skipped by the frontend
    inside any of its ``drains`` windows (node drain — in-flight work
    finishes, nothing new lands; derive windows from a planned-restart
    `FaultSchedule` via `GuardrailPolicy.drains_for`)."""

    system: str
    count: int = 1
    nodes: int = 1
    cores: int = 28
    mem_gb: float = 128.0
    backend_workers: int = 64
    max_vms_per_node: int = 280
    guardrails: GR.GuardrailPolicy | None = None
    faults: FA.FaultSchedule | None = None
    cache: CacheSpec | None = None    # per-node SharedCache (each member
                                      # host owns its own CacheState, so
                                      # affinity dispatch compounds with
                                      # cache warmth)
    drains: tuple[GR.DrainWindow, ...] = ()
    up_at_s: float = 0.0

    def __post_init__(self):
        if self.system not in SYSTEMS:
            raise ValueError(f"unknown system {self.system!r}")
        if self.count < 1:
            raise ValueError("count must be >= 1")
        if self.nodes < 1 or self.cores < 1:
            raise ValueError("nodes and cores must be >= 1")
        if self.up_at_s < 0.0:
            raise ValueError("up_at_s must be >= 0")


@dataclass(frozen=True)
class ClusterSpec:
    """A whole fleet as one immutable value: heterogeneous node groups
    plus the frontend's offered load. Defaults mirror
    `DensitySimulator`'s so a 1-node spec is the standalone sim."""

    nodes: tuple[NodeSpec, ...]
    n_functions: int
    policy: str | DispatchPolicy = "least_loaded"
    mean_rate: float = 1.6
    rate_sigma: float = 1.0
    duration_s: float = 90.0
    warmup_s: float = 15.0
    arrival_pattern: str | W.ArrivalPattern = "azure"

    def __post_init__(self):
        if not self.nodes:
            raise ValueError("a cluster needs at least one NodeSpec")
        if self.n_functions < 1:
            raise ValueError("n_functions must be >= 1")
        if self.duration_s <= 0.0:
            raise ValueError("duration_s must be > 0")
        if not 0.0 <= self.warmup_s < self.duration_s:
            raise ValueError("warmup_s must be in [0, duration_s)")
        resolve_policy(self.policy)   # fail early on unknown names

    def expand(self) -> tuple[NodeSpec, ...]:
        """One entry per member, groups flattened in declaration order."""
        return tuple(ns for ns in self.nodes for _ in range(ns.count))

    @property
    def n_members(self) -> int:
        return sum(ns.count for ns in self.nodes)


# -------------------------------------------------------------- results


@dataclass
class ClusterResult:
    """Fleet-level aggregate over the member `SimResult`s."""

    policy: str
    n_nodes: int
    n_functions: int
    offered: int
    dispatched: tuple[int, ...]
    completed: int
    cold_starts: int
    shed: dict[str, int]
    goodput: int
    slo_violations: int
    latencies: dict[str, list[float]]     # fleet-merged, member order
    node_results: tuple[SimResult, ...]
    _sorted: list[float] = field(default_factory=list, repr=False)

    def _all(self) -> list[float]:
        if not self._sorted:
            xs = [x for v in self.latencies.values() for x in v]
            xs.sort()
            self._sorted = xs
        return self._sorted

    def fleet_p(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 1]) over every completion
        in the measured window, fleet-wide. 0.0 when nothing completed."""
        xs = self._all()
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    @property
    def p50(self) -> float:
        return self.fleet_p(0.50)

    @property
    def p99(self) -> float:
        return self.fleet_p(0.99)

    def node_utilization(self) -> tuple[float, ...]:
        return tuple(r.cpu_util for r in self.node_results)

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())


# ------------------------------------------------------------ simulator


class ClusterSimulator:
    """Drive one frontend arrival stream through a dispatch policy into
    per-member `DensitySimulator` event loops on ONE virtual clock."""

    def __init__(self, spec: ClusterSpec, *, seed: int = 0,
                 engine: str = "hot",
                 suite: dict[str, W.Workload] | None = None,
                 verify_plans: bool = False,
                 record_decisions: bool = False,
                 slo_factor: float = 5.0):
        engine = _ENGINE_ALIASES.get(engine, engine)
        if engine not in ("hot", "classic", "calendar"):
            raise ValueError(
                f"cluster engine must be hot/classic/calendar, "
                f"got {engine!r}")
        self.spec = spec
        self.engine = engine
        self.policy = resolve_policy(spec.policy)
        self.slo_factor = slo_factor
        self.loop = EventLoop()
        if engine == "calendar":
            self.loop.cal = CalendarQueue()
        self.loop.hot = self._route_hot

        self._members_spec = spec.expand()
        self.members: list[DensitySimulator] = [
            DensitySimulator(
                ns.system, spec.n_functions, seed=seed, nodes=ns.nodes,
                cores=ns.cores, mem_gb=ns.mem_gb,
                duration_s=spec.duration_s, warmup_s=spec.warmup_s,
                mean_rate=spec.mean_rate,
                backend_workers=ns.backend_workers,
                rate_sigma=spec.rate_sigma,
                max_vms_per_node=ns.max_vms_per_node, suite=suite,
                arrival_pattern=spec.arrival_pattern, engine=engine,
                faults=ns.faults, guardrails=ns.guardrails,
                cache=ns.cache,
                verify_plans=verify_plans, loop=self.loop,
                gen_arrivals=False)
            for ns in self._members_spec]

        # the frontend's offered load: the exact pipeline a standalone
        # DensitySimulator runs, so the 1-node cluster sees the
        # bit-identical stream (the differential parity anchor)
        self.functions = list(self.members[0].functions)
        pattern = W.resolve_pattern(spec.arrival_pattern)
        specs = sample_rates(self.functions, seed,
                             mean_rate=spec.mean_rate,
                             sigma=spec.rate_sigma)
        self.arrivals = {s.function: generate_arrivals(
                             s, spec.duration_s, seed, pattern=pattern)
                         for s in specs}

        n = len(self.members)
        self.offered = 0
        self.dispatched = [0] * n
        self.frontend_shed = 0
        self._rr = -1
        self._rng = random.Random(
            seed * 1_000_003 + zlib.crc32(self.policy.name.encode()))
        #: (now, fn, eligible, loads, choice) per dispatch — the
        #: property suite replays these against the policy invariants
        self.decisions: list[tuple] | None = ([] if record_decisions
                                              else None)

    # --------------------------------------------------- event routing

    def _route_hot(self, run: list, code: int) -> None:
        """Send a shared-loop hot record home to the sim that made it."""
        (run[_C_OWN] if code & _CRUN else run[_R_OWN])._hot(run, code)

    # -------------------------------------------------------- dispatch

    def _inflight(self, i: int) -> int:
        m = self.members[i]
        return self.dispatched[i] - m.completed - m.rejected

    def _eligible(self, now: float) -> list[int]:
        out = []
        for i, ns in enumerate(self._members_spec):
            if ns.up_at_s > now:
                continue
            if any(d.at_s <= now < d.end_s for d in ns.drains):
                continue
            out.append(i)
        return out

    def _pick(self, fn: str, now: float) -> int | None:
        elig = self._eligible(now)
        if not elig:
            return None
        kind = self.policy.kind
        if kind == "single":
            choice = elig[0]
        elif kind == "round_robin":
            self._rr += 1
            choice = elig[self._rr % len(elig)]
        elif kind == "random":
            choice = elig[self._rng.randrange(len(elig))]
        elif kind == "least_loaded":
            # capacity-aware: in-flight per total core, so a fat node
            # absorbs proportionally more of the fleet's load
            choice = min(elig, key=lambda i: (
                self._inflight(i)
                / (self._members_spec[i].nodes
                   * self._members_spec[i].cores), i))
        elif kind == "jbsq":
            below = [i for i in elig
                     if self._inflight(i) < self.policy.bound]
            pool = below or elig
            choice = min(pool, key=lambda i: (self._inflight(i), i))
        else:                                   # affinity
            warm = [i for i in elig if self.members[i].idle[fn]]
            pool = warm or elig
            choice = min(pool, key=lambda i: (self._inflight(i), i))
        if self.decisions is not None:
            self.decisions.append(
                (now, fn, tuple(elig),
                 tuple(self._inflight(i) for i in elig), choice))
        return choice

    def _frontend(self, fn: str, _=None) -> None:
        """One offered arrival: place it or shed it (no eligible node —
        the whole fleet drained/down)."""
        self.offered += 1
        i = self._pick(fn, self.loop.now)
        if i is None:
            self.frontend_shed += 1
            return
        self.dispatched[i] += 1
        self.members[i]._arrive(fn)

    # ------------------------------------------------------------- run

    def run(self) -> ClusterResult:
        until = self.spec.duration_s + 30.0     # drain tail
        # the frontend owns the single merged stream; each member arms
        # its own horizon/faults/memory-sampler on the shared loop
        self.loop.feed(merge_streams(self.arrivals), self._frontend)
        for m in self.members:
            m._arm(until, feed=False)
        self.loop.run(until)
        return self._collect()

    def _collect(self) -> ClusterResult:
        node_results = tuple(m.collect() for m in self.members)
        merged: dict[str, list[float]] = {}
        for fn in self.functions:
            xs = [x for m in self.members for x in m.latencies[fn]]
            if xs:
                merged[fn] = xs
        # fleet goodput: measured-window completions inside
        # slo_factor x the serving member's unloaded latency (the
        # member's own plan critical path — heterogeneity-honest)
        goodput = bad = 0
        for m in self.members:
            for fn, xs in m.latencies.items():
                if not xs:
                    continue
                slo = self.slo_factor * m.unloaded_latency(fn)
                b = sum(1 for x in xs if x > slo)
                bad += b
                goodput += len(xs) - b
        shed: dict[str, int] = {"frontend": self.frontend_shed}
        for m in self.members:
            for reason, c in m.shed.items():
                if c:
                    shed[reason] = shed.get(reason, 0) + c
        return ClusterResult(
            policy=self.policy.name,
            n_nodes=len(self.members),
            n_functions=self.spec.n_functions,
            offered=self.offered,
            dispatched=tuple(self.dispatched),
            completed=sum(m.completed for m in self.members),
            cold_starts=sum(m.cold_starts for m in self.members),
            shed=shed, goodput=goodput, slo_violations=bad,
            latencies=merged, node_results=node_results)
