"""The port's density simulator (`repro_torch.core.des`) against the
reference's (`repro.core.des`), run in one process on the CPU.

Every case builds the same simulation in both packages (the same
variant, seed, sizes and suite, each package with its own workloads,
faults, guardrails and cache spec) and holds the port's `SimResult` to
the reference's *exactly*: every field, latency streams float for float,
`completed`, `cold_starts`, `cpu_util`, `mem_util`, and the fault,
guardrail and cache ledgers where a run has them. On top of that, each
class is a port copy of a reference test, asserting on the port's
results what the reference asserts on its own:

* `TestEngineEquivalence`, `test_zero_contention_program_equals_critical_path`,
  `TestDeterminism`, `TestArrivalPatterns`, `TestFindDensityRefinement`
  and `TestFluidFastPath` (`tests/test_des.py`);
* `TestDESCache` and `TestCountParity` (`tests/test_cache.py`), the
  latter against the port's own threaded `WorkerNode`;
* the guarded DES (`tests/test_guardrails.py`) and the faulted DES
  (`tests/test_faults.py`);
* `TestDESParity` for the MLServe suite at both scales
  (`tests/test_mlserve.py`).

Nothing here reads `tests/goldens/des_parity.json`: the reference's own
goldens flip from run to run, so the port is held to the reference's run
in the same process instead.
"""
import dataclasses
import hashlib
import math
from types import SimpleNamespace

import pytest

from repro.core import cache as ref_cache
from repro.core import des as ref_des
from repro.core import faults as ref_FA
from repro.core import guardrails as ref_GR
from repro.core import workloads as ref_W
from repro_torch.core import cache as port_cache
from repro_torch.core import des
from repro_torch.core import faults as FA
from repro_torch.core import guardrails as GR
from repro_torch.core import metrics as M
from repro_torch.core import workloads as W
from repro_torch.core.cache import CacheSpec
from repro_torch.core.des import DensitySimulator, find_density
from repro_torch.core.plan import SYSTEMS, compile_plan, phase_durations
from repro_torch.core.runtime import WorkerNode
from repro_torch.core.trace import (ArrivalSpec, generate_arrivals,
                                    interarrival_cv, merge_streams)

ALL_SYSTEMS = tuple(SYSTEMS)
MB = 1024 * 1024

#: each package's modules, so one function makes the same simulation in
#: both: `build(PORT)` and `build(REF)`
PORT = SimpleNamespace(des=des, W=W, FA=FA, GR=GR, cache=port_cache)
REF = SimpleNamespace(des=ref_des, W=ref_W, FA=ref_FA, GR=ref_GR,
                      cache=ref_cache)


def assert_same(port, ref):
    """The port's `SimResult` equals the reference's, field for field."""
    a, b = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert a.keys() == b.keys()
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"SimResult fields differ from the reference: {diff}"


def both(build):
    """Run `build(pkg)` (a DensitySimulator) in each package and hold
    the port's result to the reference's. Returns (result, simulator)
    of the port."""
    sim = build(PORT)
    got = sim.run()
    assert_same(got, build(REF).run())
    return got, sim


def digest(result, sim):
    """Order- and bit-sensitive fingerprint of a run's latency streams,
    `completed` and `cold_starts` (as `tests/test_des.py` takes it)."""
    h = hashlib.sha256()
    for fn in sim.functions:
        h.update(fn.encode())
        h.update(",".join(x.hex() for x in result.latencies.get(fn, []))
                 .encode())
    return (h.hexdigest(), result.completed, result.cold_starts)


def test_constants_equal_reference():
    """The register layouts, opcodes and flags, the engine names and
    the keep-alive: every module-level number of the copy."""
    def numbers(mod):
        return {n: v for n, v in vars(mod).items()
                if n.lstrip("_").isupper() and isinstance(v, (int, float))
                and not isinstance(v, bool)}
    got = numbers(des)
    assert len(got) > 40
    assert got == numbers(ref_des)
    assert des.ENGINES == ref_des.ENGINES
    assert des._ENGINE_ALIASES == ref_des._ENGINE_ALIASES
    assert DensitySimulator.KEEPALIVE_S == ref_des.DensitySimulator.KEEPALIVE_S


# -------------------------------------------------- engine equivalence

class TestEngineEquivalence:
    @pytest.mark.parametrize("engine", des.ENGINES)
    @pytest.mark.parametrize("system", ["baseline", "nexus", "nexus-tcp",
                                        "wasm"])
    def test_every_engine_equals_reference(self, system, engine):
        both(lambda P: P.des.DensitySimulator(
            system, 160, seed=1, duration_s=20.0, warmup_s=5.0,
            engine=engine))

    @pytest.mark.parametrize("system", ["baseline", "nexus"])
    def test_four_engines_give_one_digest(self, system):
        """The contract `chip_smoke.py`'s density phase checks on the
        card's host: all four engines, one latency digest."""
        digests = set()
        for engine in des.ENGINES:
            sim = DensitySimulator(system, 160, seed=1, duration_s=20.0,
                                   warmup_s=5.0, engine=engine)
            digests.add(digest(sim.run(), sim))
        assert len(digests) == 1

    @pytest.mark.parametrize("engine", des.ENGINES)
    def test_ml_suite_engines_equal_reference(self, engine):
        got, sim = both(lambda P: P.des.DensitySimulator(
            "nexus", 20, seed=1, duration_s=15.0, warmup_s=3.0,
            mean_rate=0.25, suite=P.W.ml_suite("full"), engine=engine))
        hot = DensitySimulator("nexus", 20, seed=1, duration_s=15.0,
                               warmup_s=3.0, mean_rate=0.25,
                               suite=W.ml_suite("full"))
        assert digest(got, sim) == digest(hot.run(), hot)

    def test_program_matches_legacy_off_golden_config(self):
        kw = dict(seed=11, duration_s=15.0, warmup_s=3.0)
        a, _ = both(lambda P: P.des.DensitySimulator(
            "nexus-tcp", 220, engine="legacy", suite=P.W.REGISTRY, **kw))
        b, _ = both(lambda P: P.des.DensitySimulator(
            "nexus-tcp", 220, engine="program", suite=P.W.REGISTRY, **kw))
        assert a.latencies == b.latencies
        assert a.cold_starts == b.cold_starts
        assert a.completed == b.completed
        assert a.mem_util == b.mem_util
        assert a.cpu_util == pytest.approx(b.cpu_util, rel=1e-3)

    def test_hot_method_path_matches_fused_loop(self):
        dur = 150.0
        kw = dict(seed=4, duration_s=dur, warmup_s=2.0, mean_rate=0.03)
        _, fused = both(lambda P: P.des.DensitySimulator(
            "nexus-async", 80, engine="program", **kw))
        invoked = sum(1 for v in fused.arrivals.values() if v)
        assert fused.cold_starts > invoked, \
            "some instance must retire and re-cold-start"
        stepped = DensitySimulator("nexus-async", 80, engine="program", **kw)
        stepped._horizon = dur + 30.0
        stream = [(t, fn) for fn, times in stepped.arrivals.items()
                  for t in times]
        stream.sort(key=lambda e: e[0])
        stepped.loop.feed(stream, stepped._arrive)
        stepped.loop.run(dur + 30.0)
        assert stepped.latencies == fused.latencies
        assert stepped.cold_starts == fused.cold_starts

    def test_heap_scheduled_arrivals_match_feed(self):
        kw = dict(seed=9, duration_s=10.0, warmup_s=2.0)
        _, fed = both(lambda P: P.des.DensitySimulator(
            "nexus", 120, engine="program", **kw))
        heaped = DensitySimulator("nexus", 120, engine="program", **kw)
        heaped._horizon = 40.0
        for fn, times in heaped.arrivals.items():
            for t in times:
                heaped.loop.at(t, heaped._arrive, fn)
        heaped.loop.run(40.0)
        assert heaped.latencies == fed.latencies
        assert heaped.cold_starts == fed.cold_starts

    def test_empty_fault_schedule_reproduces_hot_engine(self):
        kw = dict(seed=1, duration_s=20.0, warmup_s=4.0)
        hot, hsim = both(lambda P: P.des.DensitySimulator(
            "nexus", 160, engine="hot", **kw))
        faulted, fsim = both(lambda P: P.des.DensitySimulator(
            "nexus", 160, engine="hot", faults=P.FA.FaultSchedule(()),
            **kw))
        assert digest(faulted, fsim) == digest(hot, hsim)

    def test_invalid_engine_rejected(self):
        with pytest.raises(ValueError, match="engine"):
            DensitySimulator("nexus", 10, engine="warp")
        with pytest.raises(ValueError, match="engine"):
            ref_des.DensitySimulator("nexus", 10, engine="warp")


# ------------------------------------------- zero-contention property

@pytest.mark.parametrize("system", ALL_SYSTEMS)
@pytest.mark.parametrize("cold", [False, True])
def test_zero_contention_program_equals_critical_path(system, cold):
    """With effectively infinite resources, each invocation completes in
    exactly the plan's critical path, for every variant over the whole
    registry, warm and cold; and in exactly the reference's time."""
    def drive(P):
        sim = P.des.DensitySimulator(
            system, len(P.W.REGISTRY), seed=0, duration_s=5.0,
            warmup_s=0.0, cores=4096, backend_workers=4096, nodes=1,
            mem_gb=4096.0, suite=P.W.REGISTRY)
        for fn in sim.functions:
            inst = sim._spawn(fn)
            assert inst is not None
            inst.state = "busy"
            sim._execute(inst, 0.0, cold=cold)
        sim.loop.run(60.0)
        return sim
    sim, ref = drive(PORT), drive(REF)
    assert sim.latencies == ref.latencies
    for fn in sim.functions:
        w = sim.workload[fn]
        expect = compile_plan(sim.spec, w.profile, cold=cold).critical_path(
            phase_durations(sim.spec, w, cold))
        assert len(sim.latencies[fn]) == 1, fn
        assert math.isclose(sim.latencies[fn][0], expect, rel_tol=1e-9), fn


# ------------------------------------------------------- determinism

class TestDeterminism:
    @pytest.mark.parametrize("pattern", list(W.ARRIVAL_PATTERNS))
    def test_same_seed_identical_simresult(self, pattern):
        def once(P):
            return P.des.DensitySimulator(
                "nexus", 100, seed=13, duration_s=12.0, warmup_s=2.0,
                arrival_pattern=pattern)
        a, _ = both(once)
        b = once(PORT).run()
        assert a.latencies == b.latencies
        assert a.cold_starts == b.cold_starts
        assert a.completed == b.completed

    @pytest.mark.parametrize("system", ALL_SYSTEMS)
    def test_every_variant_equals_reference(self, system):
        both(lambda P: P.des.DensitySimulator(
            system, 120, seed=3, duration_s=20.0, warmup_s=4.0))

    def test_arrival_seed_is_not_process_salted(self):
        a = generate_arrivals(ArrivalSpec("ST-R#0", 2.0), 50.0, 7)
        assert a, "stream must be non-empty"
        assert a == generate_arrivals(ArrivalSpec("ST-R#0", 2.0), 50.0, 7)
        assert a[0] == pytest.approx(3.32083706754214, abs=1e-12)


# --------------------------------------------------- arrival patterns

class TestArrivalPatterns:
    DUR = 600.0

    def _arrivals(self, pattern, rate=4.0, seed=3):
        return generate_arrivals(
            ArrivalSpec("f#1", rate), self.DUR, seed,
            pattern=W.ARRIVAL_PATTERNS[pattern])

    @pytest.mark.parametrize("pattern", list(W.ARRIVAL_PATTERNS))
    def test_sorted_in_range_and_rate_plausible(self, pattern):
        arr = self._arrivals(pattern)
        assert all(b > a for a, b in zip(arr, arr[1:]))
        assert all(0 <= t < self.DUR for t in arr)
        assert 0.4 * 4.0 < len(arr) / self.DUR < 2.5 * 4.0

    def test_poisson_cv_near_one(self):
        cv = interarrival_cv(self._arrivals("poisson"))
        assert 0.85 < cv < 1.15

    def test_bursty_exceeds_azure_exceeds_poisson(self):
        cvs = {p: interarrival_cv(self._arrivals(p))
               for p in ("poisson", "azure", "bursty")}
        assert cvs["bursty"] > cvs["azure"] > 0.95
        assert cvs["bursty"] > 1.3

    def test_diurnal_rate_swings_with_period(self):
        arr = self._arrivals("diurnal", rate=6.0)
        width = 30.0
        counts = [0] * int(self.DUR / width)
        for t in arr:
            counts[int(t / width)] += 1
        assert max(counts) > 2.0 * max(min(counts), 1)

    def test_unknown_pattern_rejected(self):
        with pytest.raises(KeyError, match="unknown arrival pattern"):
            DensitySimulator("nexus", 10, arrival_pattern="weekly")
        with pytest.raises(ValueError, match="kind"):
            W.ArrivalPattern("x", kind="fractal")

    def test_merge_streams_empty_and_all_empty(self):
        assert merge_streams({}) == []
        assert merge_streams({"a#0": [], "b#1": []}) == []

    def test_merge_streams_single_stream_identity(self):
        times = [0.5, 0.5, 1.25, 3.0]
        out = merge_streams({"empty#0": [], "only#1": times})
        assert out == [(t, "only#1") for t in times]
        assert all(a is b for (a, _), b in zip(out, times))

    def test_merge_streams_duplicate_heavy_keeps_dict_order(self):
        fns = [f"f#{i}" for i in range(7)]
        base = [0.0, 1.0, 1.0, 2.5, 2.5, 2.5, 7.0]
        arrivals = {fn: list(base) for fn in fns}
        out = merge_streams(arrivals)
        ref = sorted(((t, fn) for fn in fns for t in base),
                     key=lambda e: e[0])
        assert out == ref
        for t in set(base):
            k = base.count(t)
            assert [fn for x, fn in out if x == t] == \
                [fn for fn in fns for _ in range(k)]

    def test_degenerate_pattern_params_rejected_at_construction(self):
        with pytest.raises(ValueError, match="burst_factor"):
            W.ArrivalPattern("x", burst_factor=0.0)
        with pytest.raises(ValueError, match="burst_fraction"):
            W.ArrivalPattern("x", burst_fraction=1.0)
        with pytest.raises(ValueError, match="amplitude"):
            W.ArrivalPattern("x", kind="diurnal", amplitude=1.0)
        with pytest.raises(ValueError, match="period_s"):
            W.ArrivalPattern("x", kind="diurnal", period_s=0.0)

    def test_simulator_arrivals_equal_reference(self):
        for pattern in W.ARRIVAL_PATTERNS:
            a = DensitySimulator("nexus", 60, seed=5, duration_s=30.0,
                                 arrival_pattern=pattern)
            b = ref_des.DensitySimulator("nexus", 60, seed=5,
                                         duration_s=30.0,
                                         arrival_pattern=pattern)
            assert a.arrivals == b.arrivals, pattern


# ------------------------------------------------ density refinement

#: tiny overloaded cluster: each probe is cheap and the SLO boundary
#: sits well inside the grid (the reference tests' settings)
TINY = dict(duration_s=8.0, warmup_s=2.0, nodes=1, cores=4, mem_gb=4.0,
            backend_workers=8, max_vms_per_node=64, mean_rate=2.5)


def _search(system, seed, *, fast, **kw):
    """`find_density` in both packages: the port's (density, probes),
    held to the reference's density and probe list."""
    got = find_density(system, seed=seed, fast=fast, **kw)
    want = ref_des.find_density(system, seed=seed, fast=fast, **kw)
    assert got[0] == want[0]
    assert [r.n_functions for r in got[1]] == [
        r.n_functions for r in want[1]]
    for a, b in zip(got[1], want[1]):
        assert_same(a, b)
    return got


class TestFindDensityRefinement:
    def test_binary_search_refines_past_step_granularity(self, monkeypatch):
        true_density = 137
        probes = []

        class FakeSim:
            def __init__(self, system, n, **kw):
                self.n = n

            def run(self):
                probes.append(self.n)
                n = self.n

                class R:
                    n_functions = n

                    @staticmethod
                    def meets_slo(slo=5.0):
                        return n <= true_density
                return R()

        monkeypatch.setattr(des, "DensitySimulator", FakeSim)
        best, results = find_density("nexus", lo=20, hi=400, step=50,
                                     refine_to=1)
        assert best == true_density
        assert len(results) == len(probes)
        assert probes[:4] == [20, 70, 120, 170]
        assert len(probes) < 12

    def test_all_pass_returns_last_probe_without_refinement(self,
                                                            monkeypatch):
        class AlwaysPass:
            def __init__(self, system, n, **kw):
                self.n = n

            def run(self):
                class R:
                    @staticmethod
                    def meets_slo(slo=5.0):
                        return True
                return R()

        monkeypatch.setattr(des, "DensitySimulator", AlwaysPass)
        best, results = find_density("nexus", lo=10, hi=50, step=20)
        assert best == 50
        assert len(results) == 3

    def test_real_refined_density_is_sandwiched(self):
        best, results = _search("baseline", 2, fast=False, lo=4, hi=120,
                                step=24, refine_to=1, **TINY)
        fails = [r.n_functions for r in results if not r.meets_slo()]
        assert fails and best < min(fails)
        assert any(r.n_functions == best and r.meets_slo()
                   for r in results)


class TestFluidFastPath:
    def _both(self, system, seed):
        kw = dict(lo=4, hi=120, step=24, refine_to=1, **TINY)
        return (_search(system, seed, fast=False, **kw),
                _search(system, seed, fast=True, **kw))

    def test_fast_matches_exact_on_real_cluster(self):
        (d_exact, r_exact), (d_fast, r_fast) = self._both("nexus", 2)
        assert d_fast == d_exact
        assert len(r_fast) <= len(r_exact) + 2

    @pytest.mark.parametrize("system,seed", [("baseline", 0),
                                             ("nexus-tcp", 5),
                                             ("nexus-sdk-only", 17),
                                             ("wasm", 30)])
    def test_fluid_bracketed_equals_exact(self, system, seed):
        (d_exact, _), (d_fast, _) = self._both(system, seed)
        assert d_fast == d_exact, (system, seed)

    def test_default_search_equals_reference(self):
        """`find_density(fast=True)` at its defaults (4 nodes x 28 cores
        x 128 GB), as `chip_smoke.py` runs it for each Fig 6 system."""
        best, results = _search("baseline", 1, fast=True)
        assert best > 0 and len(results) >= 2


# ------------------------------------------------------ SharedCache

class TestDESCache:
    def _sim(self, P, **kw):
        kw.setdefault("cache", P.cache.CacheSpec())
        return P.des.DensitySimulator("nexus", 24, seed=3, duration_s=15.0,
                                      warmup_s=3.0, **kw)

    def test_same_seed_same_result(self):
        a, _ = both(self._sim)
        b = self._sim(PORT).run()
        assert a.latencies == b.latencies
        assert a.cache_stats == b.cache_stats
        assert a.cache_stats["hits"] > 0

    def test_disabled_cache_reports_none(self):
        r, _ = both(lambda P: self._sim(P, cache=None))
        assert r.cache_stats is None

    def test_hits_shorten_latencies(self):
        def flat(r):
            return sorted(x for v in r.latencies.values() for x in v)
        cached, _ = both(self._sim)
        plain, _ = both(lambda P: self._sim(P, cache=None))
        assert sum(flat(cached)) < sum(flat(plain))

    def test_cache_disabled_templates_stay_pristine(self):
        before = self._sim(PORT, cache=None).run()
        self._sim(PORT).run()
        after = self._sim(PORT, cache=None).run()
        assert after.latencies == before.latencies

    def test_bundle_cache_is_the_port_s_own(self):
        """The port compiles into its own process-wide bundle table: a
        port run moves the port's counters and not the reference's, and
        a second run of the same variants hits every bundle."""
        des._BUNDLES.clear()
        des.bundle_cache_stats(reset=True)
        ref_des.bundle_cache_stats(reset=True)
        self._sim(PORT, cache=None).run()
        first = des.bundle_cache_stats()
        assert first["misses"] > 0
        assert ref_des.bundle_cache_stats() == {"hits": 0, "misses": 0,
                                                "compile_s": 0.0}
        self._sim(PORT, cache=None).run()
        second = des.bundle_cache_stats(reset=True)
        assert second["misses"] == first["misses"]
        assert second["hits"] > first["hits"]
        assert des.bundle_cache_stats() == {"hits": 0, "misses": 0,
                                            "compile_s": 0.0}


def _parity_suite(P):
    """Three cacheable single-I/O workloads with pairwise-distinct
    whole-MB sizes plus one fully opted out (`tests/test_cache.py`)."""
    Wm = P.W

    def out(mb):
        return lambda v: Wm._digest_n(v, mb)

    def mk(name, in_mb, out_mb):
        return Wm.Workload(name, Wm.IOProfile.single(in_mb, out_mb, 1.0),
                           30.0, Wm._single_io_handler(out(out_mb)))
    optout = Wm.Workload(
        "CD", Wm.IOProfile((Wm.Get(5 * MB, cacheable=False),
                            Wm.ComputeSegment(1.0), Wm.Put(MB))), 30.0,
        Wm._single_io_handler(out(1.0)))
    return {w.name: w for w in (mk("CA", 2.0, 1.0), mk("CB", 3.0, 2.0),
                                mk("CC", 4.0, 3.0), optout)}


PARITY_KEYS = ("lookups", "hits", "misses", "evictions", "admitted",
               "writes")


def _des_counts(P, spec_kw, order, rounds):
    suite = _parity_suite(P)
    sim = P.des.DensitySimulator("nexus", len(suite), seed=0,
                                 duration_s=300.0, warmup_s=0.0,
                                 suite=suite,
                                 cache=P.cache.CacheSpec(**spec_kw))
    names = {f.split("#")[0]: f for f in sim.functions}
    arrivals = {f: [] for f in sim.functions}
    t = 1.0
    for _ in range(rounds):
        for base in order:
            arrivals[names[base]].append(t)
            t += 5.0
    sim.arrivals = arrivals
    r = sim.run()
    assert r.completed == rounds * len(order)
    return {k: r.cache_stats[k] for k in PARITY_KEYS}, r


def _threaded_counts(spec_kw, order, rounds):
    suite = _parity_suite(PORT)
    node = WorkerNode("nexus", byte_scale=1.0, cache=CacheSpec(**spec_kw),
                      device="cpu")
    try:
        for w in suite.values():
            node.deploy(w)
            node.seed_input(w.name)
        for _ in range(rounds):
            for base in order:
                node.invoke(base).result(timeout=120)
        node.drain(timeout_s=60.0)
        snap = node.cache_stats()
        return {k: snap[k] for k in PARITY_KEYS}
    finally:
        node.shutdown()


class TestCountParity:
    """The port DES's counters equal the port's threaded node's on the
    same serial trace, and the reference DES's."""

    ORDER = ("CA", "CB", "CC", "CD")

    def _check(self, spec_kw, rounds):
        got, r = _des_counts(PORT, spec_kw, self.ORDER, rounds)
        want, rr = _des_counts(REF, spec_kw, self.ORDER, rounds)
        assert_same(r, rr)
        assert got == want
        assert got == _threaded_counts(spec_kw, self.ORDER, rounds)
        return got

    def test_no_eviction_regime(self):
        got = self._check(dict(capacity_mb=64.0), rounds=3)
        assert got["lookups"] == 9
        assert got["hits"] == 6

    @pytest.mark.parametrize("policy", ["lru", "clock", "random"])
    def test_eviction_pressure_regime(self, policy):
        got = self._check(dict(capacity_mb=12.0, policy=policy, seed=11),
                          rounds=4)
        assert got["evictions"] > 0


def test_ml_suite_cache_predicts_hits():
    """`TestMLSecondInvocationHits::test_des_ml_suite_predicts_hits`:
    the full-scale MLServe mix's stable keys turn into hits."""
    r, sim = both(lambda P: P.des.DensitySimulator(
        "nexus", 10, seed=1, duration_s=30.0, warmup_s=5.0,
        mean_rate=0.25, suite=P.W.ml_suite("full"),
        cache=P.cache.CacheSpec(capacity_mb=65536.0)))
    assert r.cache_stats["hits"] > 0
    per_fn_gets = {f: len(sim.workload[f].profile.gets)
                   for f in sim.functions}
    assert r.cache_stats["misses"] <= sum(per_fn_gets.values())


# ------------------------------------------------------- guarded DES

GUARD_KW = dict(seed=5, duration_s=8.0, warmup_s=0.0, mean_rate=4.0)


def _overload(G):
    return G.GuardrailPolicy(
        admission=G.AdmissionSpec(rate_per_s=2.0, burst=3.0,
                                  max_queue_s=1.0),
        deadline_factor=6.0)


class TestGuardedDES:
    def test_guarded_run_is_deterministic(self):
        a, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 40, guardrails=_overload(P.GR), **GUARD_KW))
        b = DensitySimulator("nexus", 40, guardrails=_overload(GR),
                             **GUARD_KW).run()
        assert_same(a, b)

    @pytest.mark.parametrize("engine", des.ENGINES)
    def test_accounting_identities(self, engine):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 40, guardrails=_overload(P.GR), engine=engine,
            **GUARD_KW))
        assert r.rejected > 0
        assert r.queued > 0
        assert r.rejected == sum(r.shed.values()) == len(r.rejections)
        assert set(r.shed) == set(GR.SHED_REASONS)
        measured = sum(len(v) for v in r.latencies.values())
        assert r.goodput + r.slo_violations == measured
        assert all(v in GR.SHED_REASONS for v in r.rejections.values())

    def test_slo_violations_without_admission_control(self):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "baseline", 60,
            guardrails=P.GR.GuardrailPolicy(deadline_factor=1.5),
            **GUARD_KW))
        assert r.rejected == 0
        assert r.slo_violations > 0
        measured = sum(len(v) for v in r.latencies.values())
        assert r.goodput + r.slo_violations == measured

    def test_scheduled_crash_opens_the_breaker(self):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 40,
            guardrails=P.GR.GuardrailPolicy(
                breaker=P.GR.BreakerSpec(open_s=0.5)),
            faults=P.FA.FaultSchedule(
                (P.FA.FaultSpec("backend_crash", 3.0),),
                restart_delay_s=0.3),
            **GUARD_KW))
        assert r.shed["breaker"] > 0
        assert r.shed["breaker"] == r.rejected
        for (fn, t), reason in r.rejections.items():
            assert reason == "breaker"
            assert 3.0 <= t < 3.5
        assert all(v == 1 for v in r.responses.values())

    def test_drain_windows_shed_inside_the_window_only(self):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 40,
            guardrails=P.GR.GuardrailPolicy(
                drains=(P.GR.DrainWindow(2.0, 1.0),)),
            **GUARD_KW))
        assert r.shed["drain"] > 0
        assert r.shed["drain"] == r.rejected
        for (fn, t), reason in r.rejections.items():
            assert reason == "drain"
            assert 2.0 <= t < 3.0

    def test_empty_policy_reproduces_every_engine(self):
        for engine in des.ENGINES:
            plain, psim = both(lambda P: P.des.DensitySimulator(
                "baseline", 120, seed=3, duration_s=20.0, warmup_s=4.0,
                engine=engine))
            guarded = DensitySimulator(
                "baseline", 120, seed=3, duration_s=20.0, warmup_s=4.0,
                engine=engine, guardrails=GR.GuardrailPolicy())
            assert digest(guarded.run(), guarded) == digest(plain, psim)

    def test_scaled_drains_shed_inside_the_stretched_window(self):
        """A policy stretched by `scaled` sheds where the stretched
        window lies, as the reference's does."""
        r, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 40,
            guardrails=P.GR.GuardrailPolicy(
                drains=(P.GR.DrainWindow(1.0, 0.5),)).scaled(2.0),
            **GUARD_KW))
        assert r.shed["drain"] > 0
        assert all(2.0 <= t < 3.0 for (_, t) in r.rejections)


# ------------------------------------------------------- faulted DES

FAULT_KW = dict(seed=3, duration_s=15.0, warmup_s=3.0)


def _crashes(P):
    return P.FA.FaultSchedule(
        (P.FA.FaultSpec(P.FA.BACKEND_CRASH, 6.001),
         P.FA.FaultSpec(P.FA.BACKEND_CRASH, 9.5)),
        restart_delay_s=0.4)


def check_des_invariants(oracle, faulted, label):
    """Exactly-once delivery and no lost or duplicated logical PUT,
    against the fault-free oracle of the same arrival stream
    (`tests/chaos.py::check_des_invariants`)."""
    dup = {k: v for k, v in faulted.responses.items() if v != 1}
    assert not dup, label
    assert faulted.responses.keys() == oracle.responses.keys(), label
    for key, puts in oracle.put_ledger.items():
        assert faulted.put_ledger.get(key) == puts, (label, key)
    s_o = sum(x for v in oracle.latencies.values() for x in v)
    s_f = sum(x for v in faulted.latencies.values() for x in v)
    assert s_f >= s_o - 1e-9, label


class TestDESFaultPlane:
    @pytest.mark.parametrize("engine", ["program", "legacy"])
    def test_empty_schedule_is_bit_for_bit_fault_free(self, engine):
        plain, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 120, engine=engine, **FAULT_KW))
        faulted, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 120, engine=engine, faults=P.FA.FaultSchedule.empty(),
            **FAULT_KW))
        assert faulted.latencies == plain.latencies
        assert faulted.cold_starts == plain.cold_starts
        assert faulted.completed == plain.completed

    @pytest.mark.parametrize("system", ["nexus", "baseline"])
    def test_engines_bit_identical_under_crashes(self, system):
        runs = [both(lambda P: P.des.DensitySimulator(
                    system, 120, engine=engine, faults=_crashes(P),
                    **FAULT_KW))[0]
                for engine in des.ENGINES]
        for r in runs[1:]:
            assert r.latencies == runs[0].latencies
            assert r.completed == runs[0].completed
            assert r.cold_starts == runs[0].cold_starts
            assert r.fault_stats == runs[0].fault_stats

    def test_offloaded_crash_aborts_groups_and_charges_books(self):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 120, faults=_crashes(P), **FAULT_KW))
        assert r.fault_stats["crashes"] == 2
        assert r.fault_stats["aborted_groups"] > 0
        assert r.fault_stats["killed_invocations"] == 0
        assert r.retry_cycles["cycles"].get(M.HOST_USER, 0.0) > 0.0
        assert r.retry_cycles["crossings"].get(M.RETRY, 0) \
            == r.fault_stats["aborted_groups"]

    def test_coupled_crash_kills_whole_invocations(self):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "baseline", 120, faults=_crashes(P), **FAULT_KW))
        assert r.fault_stats["killed_invocations"] > 0
        assert r.fault_stats["aborted_groups"] == 0
        assert r.retry_cycles["cycles"].get(M.GUEST_USER, 0.0) > 0.0
        assert all(v == 1 for v in r.responses.values())

    def test_crash_recovery_only_adds_latency(self):
        oracle, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 120, faults=P.FA.FaultSchedule.empty(), **FAULT_KW))
        faulted, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 120, faults=_crashes(P), **FAULT_KW))
        check_des_invariants(oracle, faulted, "nexus/crash")
        s_o = sum(x for v in oracle.latencies.values() for x in v)
        s_f = sum(x for v in faulted.latencies.values() for x in v)
        assert s_f > s_o

    @pytest.mark.parametrize("kind", [FA.STORAGE_SLOW, FA.STORAGE_ERROR,
                                      FA.ACK_DROP, FA.RESTORE_FAIL,
                                      FA.ARENA_EXHAUST])
    def test_windowed_faults_keep_exactly_once(self, kind):
        def sched(P):
            if kind == FA.STORAGE_SLOW:
                return P.FA.FaultSchedule(
                    (P.FA.FaultSpec(kind, 5.0, 3.0, factor=10.0),))
            return P.FA.FaultSchedule((P.FA.FaultSpec(kind, 5.0, 1.0),))
        oracle, _ = both(lambda P: P.des.DensitySimulator(
            "nexus-tcp", 80, faults=P.FA.FaultSchedule.empty(),
            **FAULT_KW))
        faulted, _ = both(lambda P: P.des.DensitySimulator(
            "nexus-tcp", 80, faults=sched(P), **FAULT_KW))
        check_des_invariants(oracle, faulted, f"nexus-tcp/{kind}")
        if kind == FA.STORAGE_ERROR:
            assert faulted.fault_stats["storage_retries"] > 0

    @pytest.mark.parametrize("seed", [0, 2790])
    def test_generated_schedule_equals_reference(self, seed):
        """A seeded chaos schedule with every fault kind, on two
        variants."""
        def sched(P):
            return P.FA.FaultSchedule.generate(
                seed, 12.0, crash_rate=0.2, storage_slow_rate=0.1,
                storage_error_rate=0.1, ack_drop_rate=0.1,
                restore_fail_rate=0.1, arena_exhaust_rate=0.1,
                mean_window_s=1.0, slow_factor=6.0, restart_delay_s=0.3)
        for system in ("nexus", "baseline"):
            oracle, _ = both(lambda P: P.des.DensitySimulator(
                system, 80, faults=P.FA.FaultSchedule.empty(), **FAULT_KW))
            faulted, _ = both(lambda P: P.des.DensitySimulator(
                system, 80, faults=sched(P), **FAULT_KW))
            check_des_invariants(oracle, faulted, f"{system}/{seed}")


# ------------------------------------------------ MLServe parity

class TestDESParity:
    @pytest.mark.parametrize("system", ALL_SYSTEMS)
    @pytest.mark.parametrize("scale", ["full", "tiny"])
    def test_zero_contention_matches_critical_path(self, system, scale):
        spec = SYSTEMS[system]
        for cold in (False, True):
            def drive(P):
                sim = P.des.DensitySimulator(
                    system, len(P.W.ml_suite(scale)), seed=0,
                    duration_s=5.0, warmup_s=0.0, cores=4096,
                    backend_workers=4096, nodes=1, mem_gb=4096.0,
                    suite=P.W.ml_suite(scale))
                for fn in sim.functions:
                    inst = sim._spawn(fn)
                    assert inst is not None
                    inst.state = "busy"
                    sim._execute(inst, 0.0, cold=cold)
                sim.loop.run(3600.0)
                return sim
            sim, ref = drive(PORT), drive(REF)
            assert sim.latencies == ref.latencies, cold
            for fn in sim.functions:
                w = sim.workload[fn]
                cp = compile_plan(spec, w.profile, cold=cold).critical_path(
                    phase_durations(spec, w, cold=cold))
                assert len(sim.latencies[fn]) == 1, (fn, cold)
                assert math.isclose(sim.latencies[fn][0], cp,
                                    rel_tol=1e-9), (fn, cold)

    def test_loaded_full_scale_run_completes(self):
        r, _ = both(lambda P: P.des.DensitySimulator(
            "nexus", 20, seed=1, duration_s=15.0, warmup_s=3.0,
            mean_rate=0.25, suite=P.W.ml_suite("full")))
        assert r.completed > 0
        assert r.meets_slo()
