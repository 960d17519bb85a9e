"""Fluid (mean-value) approximation of `DensitySimulator` probes.

`find_density` answers one question per probe: does deploying `n`
functions keep the geomean p99 slowdown under the SLO? The fluid model
answers the same question from first principles without running a
single event: per-function offered rates (the *same* seeded lognormal
draw the simulator uses), core-seconds per invocation from the
compiled plan's duration vector, and a memory-collapse gate on the
warm-pool footprint. An M/M/c-style slowdown curve maps core
utilization to a predicted p99 slowdown; burstier arrival patterns
saturate earlier, captured by a per-pattern tail constant.

The estimate is deliberately coarse — it only has to land within a
couple of grid steps of the true boundary. `find_density(fast=True)`
uses it to pick a starting grid point, then drives the *exact* engine
to locate the boundary and refine, so the returned density is the
exact search's answer whenever pass/fail is monotone along the grid
(the same assumption the exact coarse-sweep already makes).

This module imports only plan/trace/workloads/fabric; `des` imports it
lazily to avoid a cycle.

A copy of ``repro.core.fluid``, whole. Every constant keeps the
reference's value.
"""
from __future__ import annotations


from repro_torch.core import fabric as F
from repro_torch.core import plan as P
from repro_torch.core import workloads as W
from repro_torch.core.plan import SYSTEMS, compile_program
from repro_torch.core.trace import sample_rates

#: effective-load factor per arrival-pattern kind: multiplies mean
#: core utilization before the slowdown curve, absorbing everything
#: the mean-value model ignores (burst peaks vs means, queueing at
#: finite backend pools, cold-start amplification). Fitted once
#: against exact `find_density` boundaries over all 7 variants x
#: 3 seeds x {azure, poisson} at the density-bench quick config; the
#: implied factor at each observed boundary clusters at ~0.78 for
#: MMPP-like arrivals and ~0.71 for Poisson (burstier saturates
#: earlier, hence the larger factor). The fast search only needs the
#: estimate within ~2 grid steps — the exact walk does the rest.
_TAIL = {"mmpp": 0.78, "poisson": 0.71, "diurnal": 0.75}
_TAIL_DEFAULT = 0.78

#: fraction of node memory the warm pool can occupy before cold-start
#: thrash collapses tail latency
_MEM_CRIT = 0.92


def _workload_stats(system: str, suite: dict[str, "W.Workload"]):
    """Per-workload (core_seconds, solo_span, instance_rss_mb), warm."""
    spec = SYSTEMS[system]
    out = {}
    for name, w in suite.items():
        prog = compile_program(spec, w.profile, cold=False,
                               kernel_bypass=False)
        durs = P.duration_vector(spec, w, False)
        core_s = sum(d for d, oc in zip(durs, prog.on_core) if oc)
        # solo span: replay the DAG (plain max-plus, no parity needed)
        n = len(durs)
        ends = [0.0] * n
        for i in range(n):
            m = 0.0
            for p in prog.pred[i]:
                if ends[p] > m:
                    m = ends[p]
            ends[i] = m + durs[i]
        rss = F.instance_memory(w.extra_libs_mb,
                                spec.memory_variant).total()
        out[name] = (core_s, max(ends), rss)
    return out


def fluid_passes(system: str, n: int, *, seed: int = 0, slo: float = 5.0,
                 nodes: int = 4, cores: int = 28, mem_gb: float = 128.0,
                 mean_rate: float = 1.6, rate_sigma: float = 1.0,
                 max_vms_per_node: int = 280,
                 suite: dict[str, "W.Workload"] | None = None,
                 arrival_pattern: str | "W.ArrivalPattern" = "azure",
                 _stats=None, **_ignored) -> bool:
    """Fluid pass/fail prediction for one `DensitySimulator` probe.

    Accepts (a superset of) `DensitySimulator.__init__` keywords so
    `find_density` can forward its `**kw` unchanged; simulation-only
    knobs (duration, engine, ...) are ignored.
    """
    suite = suite if suite is not None else W.SUITE
    stats = _stats if _stats is not None else _workload_stats(system, suite)
    pattern = W.resolve_pattern(arrival_pattern)
    tail = _TAIL.get(pattern.kind, _TAIL_DEFAULT)

    names = list(suite)
    fns = [f"{names[i % len(names)]}#{i}" for i in range(n)]
    specs = sample_rates(fns, seed, mean_rate=mean_rate, sigma=rate_sigma)

    demand = 0.0            # core-seconds per second, cluster-wide
    mem_mb = 0.0            # warm-pool footprint
    vms = 0.0
    for s in specs:
        core_s, span, rss = stats[s.function.split("#")[0]]
        demand += s.mean_rate * core_s
        # mean warm instances: at least one (keep-alive outlives the
        # run), more when per-function concurrency exceeds one
        inst = max(1.0, s.mean_rate * span)
        mem_mb += inst * rss
        vms += inst

    if vms > nodes * max_vms_per_node:
        return False
    if mem_mb > _MEM_CRIT * nodes * mem_gb * 1024.0:
        return False

    rho = tail * demand / (nodes * cores)
    if rho >= 1.0:
        return False
    # M/M/c-flavored tail: slowdown ~ 1 / (1 - rho) as saturation nears
    return 1.0 / (1.0 - rho) < slo


def fluid_first_fail(system: str, *, lo: int, hi: int, step: int,
                     **kw) -> int | None:
    """First grid point `lo + k*step <= hi` the fluid model predicts to
    fail the SLO, or None if the whole grid is predicted to pass."""
    suite = kw.get("suite") or W.SUITE
    stats = _workload_stats(system, suite)
    n = lo
    while n <= hi:
        if not fluid_passes(system, n, _stats=stats, **kw):
            return n
        n += step
    return None
