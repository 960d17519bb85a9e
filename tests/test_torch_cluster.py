"""The port's fleet model (`repro_torch.core.cluster`) against the
reference's (`repro.core.cluster`), run in one process on the CPU.

Every case builds the same fleet in both packages (the same node groups,
policy, seed, sizes and suite, each package with its own guardrails,
faults, workloads and cache spec) and holds the port's `ClusterResult`
to the reference's *exactly*: every field, the member `SimResult`s
included, latency streams float for float. On top of that, each class is
a port copy of a reference test, asserting on the port's results what
the reference asserts on its own: `TestPolicyData`,
`TestSingleNodeParity`, `TestPolicyProperties`, `TestNodeLifecycle` and
`TestFleetBehavior` (`tests/test_cluster.py`) and `TestClusterCache`
(`tests/test_cache.py`).

Nothing here reads `tests/goldens/des_parity.json`: the reference's own
goldens flip from run to run, so the `cluster1/nexus/n160/seed7` spec is
held to the reference's run of it in the same process instead.
"""
import dataclasses
from types import SimpleNamespace

import pytest

from repro.core import cache as ref_cache
from repro.core import cluster as ref_cluster
from repro.core import des as ref_des
from repro.core import faults as ref_FA
from repro.core import guardrails as ref_GR
from repro.core import workloads as ref_W
from repro_torch.core import cache as port_cache
from repro_torch.core import cluster
from repro_torch.core import des
from repro_torch.core import faults as FA
from repro_torch.core import guardrails as GR
from repro_torch.core import workloads as W
from repro_torch.core.cluster import (DISPATCH_POLICIES, ClusterSimulator,
                                      ClusterSpec, DispatchPolicy, NodeSpec,
                                      resolve_policy)
from repro_torch.core.des import DensitySimulator, EventLoop
from tests._hypothesis_compat import HealthCheck, given, settings, st

ALL_POLICIES = sorted(DISPATCH_POLICIES)
#: the five fleet strategies `benchmarks/cluster.py` compares
FLEET_POLICIES = ("round_robin", "random", "least_loaded", "jbsq",
                  "affinity")

#: each package's modules, so one function builds the same fleet in both
PORT = SimpleNamespace(cluster=cluster, des=des, W=W, FA=FA, GR=GR,
                       cache=port_cache)
REF = SimpleNamespace(cluster=ref_cluster, des=ref_des, W=ref_W, FA=ref_FA,
                      GR=ref_GR, cache=ref_cache)


def assert_same(port, ref):
    """The port's `ClusterResult` equals the reference's, field for
    field, with its member `SimResult`s and its derived statistics."""
    a, b = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert a.keys() == b.keys()
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"ClusterResult fields differ from the reference: {diff}"
    assert (port.p50, port.p99, port.shed_total) == \
        (ref.p50, ref.p99, ref.shed_total)
    assert port.node_utilization() == ref.node_utilization()


def both(build):
    """Run `build(pkg)` (a ClusterSimulator) in each package and hold
    the port's result, and its recorded dispatch decisions, to the
    reference's. Returns (result, simulator) of the port."""
    sim, ref = build(PORT), build(REF)
    got = sim.run()
    assert_same(got, ref.run())
    assert sim.decisions == ref.decisions
    return got, sim


def tiny_fleet(P, **overrides):
    """`tests/test_cluster.py::_tiny_fleet` in package `P`: a small
    heterogeneous 4-node fleet cheap enough for unit tests."""
    kw = dict(n_functions=24, duration_s=6.0, warmup_s=1.0,
              mean_rate=1.2)
    kw.update(overrides)
    node = P.cluster.NodeSpec
    nodes = kw.pop("nodes", None) or (
        node("nexus", count=2, cores=4, mem_gb=6.0,
             backend_workers=8, max_vms_per_node=48),
        node("baseline", count=1, cores=8, mem_gb=8.0,
             backend_workers=8, max_vms_per_node=64),
        node("nexus-async", count=1, cores=4, mem_gb=6.0,
             backend_workers=8, max_vms_per_node=48),
    )
    return P.cluster.ClusterSpec(nodes=nodes, **kw)


def slim_nexus(P, **kw):
    """The 4-core nexus box the lifecycle tests fleet is made of."""
    return P.cluster.NodeSpec("nexus", cores=4, mem_gb=6.0,
                              backend_workers=8, max_vms_per_node=48, **kw)


def bench_fleet(P, n):
    """`benchmarks/cluster.py::fleet(n)` in package `P`: ~1/8 fat
    `baseline` boxes, ~1/4 `nexus-async`, the rest `nexus`."""
    n_base = max(1, n // 8)
    n_async = max(1, n // 4)
    slim = dict(nodes=1, cores=8, mem_gb=16.0, backend_workers=16,
                max_vms_per_node=70)
    node = P.cluster.NodeSpec
    return (node("nexus", count=n - n_base - n_async, **slim),
            node("nexus-async", count=n_async, **slim),
            node("baseline", count=n_base, nodes=1, cores=16, mem_gb=24.0,
                 backend_workers=16, max_vms_per_node=100))


def test_constants_equal_reference():
    assert cluster.POLICY_KINDS == ref_cluster.POLICY_KINDS
    assert {n: dataclasses.astuple(p)
            for n, p in DISPATCH_POLICIES.items()} == \
        {n: dataclasses.astuple(p)
         for n, p in ref_cluster.DISPATCH_POLICIES.items()}
    assert [f.name for f in dataclasses.fields(cluster.ClusterResult)] == \
        [f.name for f in dataclasses.fields(ref_cluster.ClusterResult)]
    for cls in ("NodeSpec", "ClusterSpec"):
        got = getattr(cluster, cls)
        want = getattr(ref_cluster, cls)
        assert [(f.name, f.default) for f in dataclasses.fields(got)] == \
            [(f.name, f.default) for f in dataclasses.fields(want)]


def test_owner_slots_are_the_port_des_s():
    """The shared loop routes hot events home through the DES's owner
    slots; a slot taken from the wrong module would route silently."""
    assert (cluster._R_OWN, cluster._C_OWN, cluster._CRUN) == \
        (des._R_OWN, des._C_OWN, des._CRUN)
    assert cluster.EventLoop is des.EventLoop
    assert cluster.CalendarQueue is des.CalendarQueue
    assert cluster.DensitySimulator is des.DensitySimulator
    assert cluster.SimResult is des.SimResult


# ------------------------------------------------------ policies as data

class TestPolicyData:
    def test_registry_covers_the_required_policies(self):
        assert {"single", "random", "round_robin", "least_loaded",
                "jbsq", "affinity"} <= set(DISPATCH_POLICIES)
        for p in DISPATCH_POLICIES.values():
            assert resolve_policy(p.name) is p

    def test_resolve_passthrough_and_unknown(self):
        p = DispatchPolicy("jbsq8", kind="jbsq", bound=8)
        assert resolve_policy(p) is p
        with pytest.raises(ValueError, match="unknown dispatch policy"):
            resolve_policy("power-of-two")

    def test_policy_validation(self):
        with pytest.raises(ValueError, match="kind"):
            DispatchPolicy("x", kind="fifo")
        with pytest.raises(ValueError, match="bound"):
            DispatchPolicy("x", kind="jbsq", bound=0)

    def test_cluster_spec_validation(self):
        ns = NodeSpec("nexus")
        with pytest.raises(ValueError, match="at least one"):
            ClusterSpec(nodes=(), n_functions=4)
        with pytest.raises(ValueError, match="n_functions"):
            ClusterSpec(nodes=(ns,), n_functions=0)
        with pytest.raises(ValueError, match="warmup_s"):
            ClusterSpec(nodes=(ns,), n_functions=4, duration_s=5.0,
                        warmup_s=5.0)
        with pytest.raises(ValueError, match="unknown dispatch policy"):
            ClusterSpec(nodes=(ns,), n_functions=4, policy="best")
        with pytest.raises(ValueError, match="unknown system"):
            NodeSpec("nexus-quantum")
        with pytest.raises(ValueError, match="count"):
            NodeSpec("nexus", count=0)
        with pytest.raises(ValueError, match="up_at_s"):
            NodeSpec("nexus", up_at_s=-1.0)

    def test_expand_flattens_groups_in_order(self):
        spec = tiny_fleet(PORT)
        members = spec.expand()
        assert len(members) == spec.n_members == 4
        assert [m.system for m in members] == \
            ["nexus", "nexus", "baseline", "nexus-async"]

    def test_cluster_engine_surface(self):
        spec = tiny_fleet(PORT)
        with pytest.raises(ValueError, match="hot/classic/calendar"):
            ClusterSimulator(spec, engine="legacy")
        assert ClusterSimulator(spec, engine="program").engine == "classic"
        with pytest.raises(ValueError, match="external loop"):
            DensitySimulator("nexus", 4, engine="legacy", loop=EventLoop())


# -------------------------------------------------- differential parity

class TestSingleNodeParity:
    def test_golden_spec_equals_reference_and_standalone(self):
        """The `cluster1/nexus/n160/seed7` spec: the cluster frontend (1
        node, trivial policy, shared-loop hot engine) equals the
        reference's run of it and the port's standalone simulator."""
        got, sim = both(lambda P: P.cluster.ClusterSimulator(
            P.cluster.ClusterSpec(nodes=(P.cluster.NodeSpec("nexus",
                                                            nodes=4),),
                                  n_functions=160, policy="single",
                                  duration_s=20.0, warmup_s=4.0),
            seed=7))
        alone = DensitySimulator("nexus", 160, seed=7, duration_s=20.0,
                                 warmup_s=4.0).run()
        assert got.latencies == alone.latencies
        assert got.completed == alone.completed
        assert got.cold_starts == alone.cold_starts

    def test_off_golden_config_matches_standalone_exactly(self):
        kw = dict(seed=11, duration_s=10.0, warmup_s=2.0)
        r = DensitySimulator("nexus-tcp", 90, suite=W.REGISTRY, **kw).run()
        c, _ = both(lambda P: P.cluster.ClusterSimulator(
            P.cluster.ClusterSpec(nodes=(P.cluster.NodeSpec("nexus-tcp",
                                                            nodes=4),),
                                  n_functions=90, policy="single",
                                  duration_s=10.0, warmup_s=2.0),
            seed=11, suite=P.W.REGISTRY))
        assert c.latencies == r.latencies
        assert c.completed == r.completed
        assert c.cold_starts == r.cold_starts
        assert c.dispatched == (c.offered,)

    def test_guarded_member_matches_standalone_guarded_sim(self):
        def policy(P):
            return P.GR.GuardrailPolicy(
                admission=P.GR.AdmissionSpec(rate_per_s=40.0, burst=20,
                                             max_queue_s=0.05))
        r = DensitySimulator("nexus", 60, guardrails=policy(PORT), seed=5,
                             duration_s=8.0, warmup_s=2.0).run()
        c, _ = both(lambda P: P.cluster.ClusterSimulator(
            P.cluster.ClusterSpec(
                nodes=(P.cluster.NodeSpec("nexus", nodes=4,
                                          guardrails=policy(P)),),
                n_functions=60, policy="single", duration_s=8.0,
                warmup_s=2.0),
            seed=5))
        assert c.latencies == r.latencies
        assert c.completed == r.completed
        assert sum(c.shed.values()) - c.shed["frontend"] == r.rejected


# ------------------------------------------------- hypothesis properties

#: the random-fleet atoms `tests/test_cluster.py` assembles ClusterSpecs
#: from, as (system, count, cores) so each package builds its own
_NODE_ATOMS = tuple((system, count, cores)
                    for system in ("nexus", "baseline", "nexus-async")
                    for count in (1, 2)
                    for cores in (2, 5))


def _random_spec(P, atoms, n_functions, mean_rate, pattern, policy):
    nodes = tuple(P.cluster.NodeSpec(system, count=count, cores=cores,
                                     mem_gb=6.0, backend_workers=8,
                                     max_vms_per_node=40)
                  for system, count, cores in atoms)
    return P.cluster.ClusterSpec(nodes=nodes, n_functions=n_functions,
                                 policy=policy, mean_rate=mean_rate,
                                 duration_s=5.0, warmup_s=1.0,
                                 arrival_pattern=pattern)


class TestPolicyProperties:
    @settings(max_examples=6, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(st.sampled_from(_NODE_ATOMS), min_size=1, max_size=3),
           st.integers(8, 20), st.sampled_from([0.8, 1.5]),
           st.sampled_from(sorted(W.ARRIVAL_PATTERNS)),
           st.sampled_from(ALL_POLICIES), st.integers(0, 1000))
    def test_conservation_and_determinism(self, atoms, n_functions,
                                          mean_rate, pattern, policy,
                                          seed):
        r, sim = both(lambda P: P.cluster.ClusterSimulator(
            _random_spec(P, atoms, n_functions, mean_rate, pattern,
                         policy), seed=seed))
        assert r.offered == sum(len(v) for v in sim.arrivals.values())
        assert r.offered == sum(r.dispatched) + r.shed["frontend"]
        r2 = ClusterSimulator(_random_spec(PORT, atoms, n_functions,
                                           mean_rate, pattern, policy),
                              seed=seed).run()
        assert r2.dispatched == r.dispatched
        assert r2.latencies == r.latencies
        assert r2.shed == r.shed

    @settings(max_examples=6, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(st.sampled_from(_NODE_ATOMS), min_size=1, max_size=3),
           st.integers(8, 20), st.sampled_from([0.8, 1.5]),
           st.sampled_from(sorted(W.ARRIVAL_PATTERNS)),
           st.sampled_from(["least_loaded", "jbsq"]),
           st.integers(0, 1000))
    def test_queue_aware_policies_never_bypass_an_idle_node(
            self, atoms, n_functions, mean_rate, pattern, policy, seed):
        bound = DISPATCH_POLICIES["jbsq"].bound
        _, sim = both(lambda P: P.cluster.ClusterSimulator(
            _random_spec(P, atoms, n_functions, mean_rate, pattern,
                         policy), seed=seed, record_decisions=True))
        assert sim.decisions, "stream must dispatch something"
        for now, fn, elig, loads, choice in sim.decisions:
            chosen = loads[elig.index(choice)]
            if min(loads) == 0:
                assert chosen <= bound
            if policy == "jbsq":
                assert chosen == min(loads)


# -------------------------------------------------- node add / drain

class TestNodeLifecycle:
    def test_drained_node_receives_nothing(self):
        def spec(P):
            whole_run = (P.GR.DrainWindow(0.0, 60.0),)
            return tiny_fleet(P, nodes=(slim_nexus(P),
                                        slim_nexus(P, drains=whole_run)),
                              policy="round_robin")
        r, _ = both(lambda P: P.cluster.ClusterSimulator(spec(P), seed=3))
        assert r.dispatched[1] == 0
        assert r.dispatched[0] == r.offered

    def test_whole_fleet_drained_sheds_at_frontend(self):
        def spec(P):
            return tiny_fleet(P, nodes=(slim_nexus(
                P, drains=(P.GR.DrainWindow(0.0, 60.0),)),))
        r, _ = both(lambda P: P.cluster.ClusterSimulator(spec(P), seed=3))
        assert r.offered > 0
        assert r.shed["frontend"] == r.offered
        assert r.completed == 0

    def test_node_add_joins_mid_run(self):
        def spec(P):
            return tiny_fleet(P, nodes=(slim_nexus(P),
                                        slim_nexus(P, up_at_s=3.0)),
                              policy="round_robin", duration_s=6.0)
        r, sim = both(lambda P: P.cluster.ClusterSimulator(
            spec(P), seed=3, record_decisions=True))
        before = [d for d in sim.decisions if d[0] < 3.0]
        after = [d for d in sim.decisions if d[0] >= 3.0]
        assert before and after
        assert all(d[4] == 0 for d in before)
        assert any(d[4] == 1 for d in after)
        assert r.dispatched[1] > 0

    def test_drains_derive_from_planned_restart_schedule(self):
        def drains(P):
            sched = P.FA.FaultSchedule((P.FA.FaultSpec("backend_crash",
                                                       2.5),),
                                       restart_delay_s=0.5)
            return P.GR.GuardrailPolicy.drains_for(sched)
        windows = drains(PORT)
        assert windows and all(isinstance(d, GR.DrainWindow)
                               for d in windows)

        def spec(P):
            return tiny_fleet(P, nodes=(slim_nexus(P),
                                        slim_nexus(P, drains=drains(P))),
                              policy="round_robin")
        _, sim = both(lambda P: P.cluster.ClusterSimulator(
            spec(P), seed=3, record_decisions=True))
        for now, fn, elig, loads, choice in sim.decisions:
            if any(d.at_s <= now < d.end_s for d in windows):
                assert choice == 0, now


# ------------------------------------------------------------ behavior

class TestFleetBehavior:
    def test_affinity_reuses_warm_instances(self):
        base = dict(n_functions=32, duration_s=8.0, warmup_s=1.0,
                    mean_rate=1.2)
        rr, _ = both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, policy="round_robin", **base), seed=9))
        aff, _ = both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, policy="affinity", **base), seed=9))
        assert aff.cold_starts < 0.6 * rr.cold_starts
        assert aff.offered == rr.offered

    def test_aggregate_identities(self):
        r, _ = both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, policy="least_loaded"), seed=4))
        assert r.n_nodes == 4
        assert r.completed == sum(nr.completed for nr in r.node_results)
        assert r.cold_starts == sum(nr.cold_starts
                                    for nr in r.node_results)
        n_lat = sum(len(v) for v in r.latencies.values())
        assert r.goodput + r.slo_violations == n_lat
        assert len(r.node_utilization()) == 4
        assert all(0.0 <= u <= 1.0 for u in r.node_utilization())
        assert r.p50 <= r.p99 <= max(x for v in r.latencies.values()
                                     for x in v)
        assert r.fleet_p(0.0) == min(x for v in r.latencies.values()
                                     for x in v)
        assert r.shed_total == sum(r.shed.values())

    def test_empty_result_percentiles(self):
        r, _ = both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, nodes=(P.cluster.NodeSpec(
                "nexus", drains=(P.GR.DrainWindow(0.0, 60.0),)),)),
            seed=3))
        assert r.p50 == r.p99 == 0.0

    def test_calendar_engine_matches_hot_fleet_wide(self):
        hot, _ = both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, policy="jbsq"), seed=6))
        cal, _ = both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, policy="jbsq"), seed=6, engine="calendar"))
        assert cal.latencies == hot.latencies
        assert cal.dispatched == hot.dispatched
        assert cal.cold_starts == hot.cold_starts

    @pytest.mark.parametrize("engine", ["hot", "classic", "calendar"])
    def test_engines_equal_reference_on_a_mixed_fleet(self, engine):
        both(lambda P: P.cluster.ClusterSimulator(
            tiny_fleet(P, policy="affinity"), seed=2, engine=engine))

    @pytest.mark.parametrize("policy", FLEET_POLICIES)
    def test_bench_fleet_policy_equals_reference(self, policy):
        """One differential per fleet policy on `benchmarks/cluster.py`'s
        smallest mixed fleet (n 4, 10 functions a box, azure arrivals,
        the bench's seed 5), with every dispatch decision recorded."""
        r, _ = both(lambda P: P.cluster.ClusterSimulator(
            P.cluster.ClusterSpec(nodes=bench_fleet(P, 4), n_functions=40,
                                  policy=policy, mean_rate=1.0,
                                  duration_s=15.0, warmup_s=3.0),
            seed=5, record_decisions=True))
        assert r.completed > 0
        assert r.offered == sum(r.dispatched) + r.shed["frontend"]

    def test_bench_headline_shape_policies_are_distinct(self):
        """The bench's acceptance bar, on a 16-box fleet of its shape:
        at least 3 of the five policies give distinct (goodput, p99)."""
        outcomes = {}
        for policy in FLEET_POLICIES:
            spec = ClusterSpec(nodes=bench_fleet(PORT, 16), n_functions=160,
                               policy=policy, mean_rate=1.0,
                               duration_s=15.0, warmup_s=3.0)
            r = ClusterSimulator(spec, seed=5).run()
            outcomes[policy] = (r.goodput, r.p99)
        assert len(set(outcomes.values())) >= 3, outcomes

    def test_faulted_member_equals_reference(self):
        def spec(P):
            sched = P.FA.FaultSchedule((P.FA.FaultSpec("backend_crash",
                                                       2.0),),
                                       restart_delay_s=0.5)
            return tiny_fleet(P, nodes=(
                P.cluster.NodeSpec("nexus", cores=4, mem_gb=6.0,
                                   backend_workers=8, max_vms_per_node=48,
                                   faults=sched),
                slim_nexus(P)), policy="least_loaded")
        both(lambda P: P.cluster.ClusterSimulator(spec(P), seed=8))


# -------------------------------------------------------------- cache

class TestClusterCache:
    def test_per_node_caches_are_independent(self):
        res, _ = both(lambda P: P.cluster.ClusterSimulator(
            P.cluster.ClusterSpec(
                nodes=(P.cluster.NodeSpec("nexus",
                                          cache=P.cache.CacheSpec()),
                       P.cluster.NodeSpec("nexus")),
                n_functions=24, policy="round_robin",
                duration_s=15.0, warmup_s=3.0),
            seed=3))
        cached, plain = res.node_results
        assert cached.cache_stats is not None
        assert cached.cache_stats["lookups"] > 0
        assert plain.cache_stats is None
