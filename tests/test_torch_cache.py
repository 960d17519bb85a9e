"""The port's SharedCache (`repro_torch.core.cache`) against the
reference's (`repro.core.cache`), on the CPU.

What is held:

* `CacheState`: the same seeded operation list (lookups with and
  without a revalidation verdict, hinted and unhinted fills, writes,
  invalidations) through both machines under lru, clock and seeded
  random eviction, with write-allocation and admission switched, gives
  the same return values, the same ``on_free`` / ``on_evict`` call
  sequence and equal snapshots after every operation;
* `SharedCache`: the reference's tier tests (fill then hit, never stale
  under a re-driven PUT, deleted objects, arena fallback with counters
  that do not depend on it, immutable hits, the losing fill racer, the
  write-through without allocation, cross-tenant dedup), each run on
  both packages with the same observations;
* the worker node: the same invocations through both nodes give equal
  `cache_stats()` and backend cache-hit counts (the port of
  `TestMLSecondInvocationHits` for every MLServe scenario, and of
  `TestPerOrdinalAdmission`), and a crash cannot serve a stale cached
  input;
* transparency with the cache on: every MLServe scenario, invoked twice
  under each of the 7 variants, leaves durable outputs byte-identical
  across variants and invocations, equal to the port's core on the same
  payloads and within the cores' tolerance of the reference's.

Left out, because they need the reference's DES, which the port has not
copied: `TestDESCache`, `TestCountParity`, `TestClusterCache`, the DES
half of `TestMLSecondInvocationHits` and `TestVerifyCacheOverlay` (the
overlay checker itself is held in `tests/test_torch_verify.py`).
"""
import functools

import numpy as np
import pytest

from repro.core import cache as ref_cache
from repro.core import frontend as ref_frontend
from repro.core import metrics as ref_metrics
from repro.core import runtime as ref_runtime
from repro.core import storage as ref_storage
from repro.core import workloads as ref_workloads
from repro.models import serving as ref_serving
from repro_torch.core import cache, frontend, metrics, runtime, storage
from repro_torch.core import workloads
from repro_torch.core.plan import SYSTEMS
from repro_torch.models import serving
from test_torch_runtime import _assert_matches_reference

PORT = (cache, storage)
REF = (ref_cache, ref_storage)
TIMEOUT = 120


# ------------------------------------------------------------- CacheState

def _ops(seed, n=400):
    """A seeded operation list over 8 logical keys and 6 contents whose
    sizes force evictions in a 4 KB cache."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(256, 1800, 6)]
    ops = []
    for _ in range(n):
        verb = ["lookup", "lookup", "fill", "write", "invalidate"][
            int(rng.integers(0, 5))]
        lk = f"k{int(rng.integers(0, 8))}"
        c = int(rng.integers(0, 6))
        ops.append((verb, lk, f"c{c}", sizes[c], bool(rng.integers(0, 2)),
                    bool(rng.integers(0, 6))))
    return ops


def _drive_state(C, spec_kw, ops):
    """Every operation's return value, the callbacks it fired and the
    snapshot after it."""
    fired = []
    st = C.CacheState(C.CacheSpec(**spec_kw),
                      on_free=lambda ck: fired.append(("free", ck)),
                      on_evict=lambda lk: fired.append(("evict", lk)))
    trace = []
    for verb, lk, ck, size, hinted, fresh in ops:
        if verb == "lookup":
            out = st.lookup(lk, valid=(None if hinted
                                       else lambda _lk, _ck, f=fresh: f))
        elif verb == "fill":
            out = st.fill(lk, ck, size, hinted=hinted)
        elif verb == "write":
            out = st.write(lk, ck, size)
        else:
            out = st.invalidate(lk)
        trace.append((out, tuple(fired), st.snapshot()))
        fired.clear()
    return trace


SPECS = {
    "lru": {"policy": "lru"},
    "clock": {"policy": "clock"},
    "random seed 3": {"policy": "random", "seed": 3},
    "random seed 11": {"policy": "random", "seed": 11},
    "lru admit all, no write allocation": {"policy": "lru", "admit": "all",
                                           "write_allocate": False},
    "clock admit all": {"policy": "clock", "admit": "all"},
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec", list(SPECS))
def test_cache_state_sequences_equal_reference(spec, seed):
    kw = {"capacity_mb": 4096 / cache.MB, **SPECS[spec]}
    ops = _ops(seed)
    port, ref = (_drive_state(C, kw, ops) for C, _ in (PORT, REF))
    assert port == ref
    final = port[-1][2]
    # the list really exercised the machine: hits, misses, evictions
    # and dedup all happened
    assert final["hits"] and final["misses"] and final["evictions"]
    assert final["dedup_bytes"] or kw.get("write_allocate") is False


def test_cache_spec_defaults_and_checks_equal_reference():
    import dataclasses
    assert (dataclasses.asdict(cache.CacheSpec())
            == dataclasses.asdict(ref_cache.CacheSpec()))
    assert cache.POLICIES == ref_cache.POLICIES
    assert cache.ADMISSIONS == ref_cache.ADMISSIONS
    assert cache.MB == ref_cache.MB
    assert cache._SHARED_ARENA == ref_cache._SHARED_ARENA
    for n in (0, 1, 4096, 16_060_522_496):
        assert (cache.CacheSpec().hit_duration_s(n)
                == ref_cache.CacheSpec().hit_duration_s(n))
    for bad in ({"policy": "fifo"}, {"admit": "none"}, {"capacity_mb": 0},
                {"hit_gbps": 0.0}):
        for C in (cache, ref_cache):
            with pytest.raises(ValueError):
                C.CacheSpec(**bad)


# ------------------------------------------------------------ SharedCache

def _store(S):
    store = S.ObjectStore()
    store.put("in", "k", b"x" * 4096)
    return store


def tier_fill_then_hit(C, S):
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    etag = store.head("in", "k").etag
    assert c.get("t", "in", "k", store) is None
    c.fill("t", "in", "k", store.get("in", "k"), 4096, hinted=True,
           etag=etag)
    assert c.get("t", "in", "k", store) == b"x" * 4096
    return c.snapshot()


def tier_stale_etag_never_served(C, S):
    """A re-driven PUT bumps the object's etag: the next GET revalidates
    and misses, and the refill serves the new version."""
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    c.fill("t", "in", "k", store.get("in", "k"), 4096, hinted=True,
           etag=store.head("in", "k").etag)
    before = store.head("in", "k").etag
    store.put("in", "k", b"y" * 4096)
    assert store.head("in", "k").etag > before
    assert c.get("t", "in", "k", store) is None
    assert c.snapshot()["stale_invalidations"] == 1
    c.fill("t", "in", "k", store.get("in", "k"), 4096, hinted=True,
           etag=store.head("in", "k").etag)
    assert c.get("t", "in", "k", store) == b"y" * 4096
    return c.snapshot()


def tier_deleted_object_invalidates(C, S):
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    c.fill("t", "in", "k", store.get("in", "k"), 4096, hinted=True,
           etag=store.head("in", "k").etag)
    store.delete("in", "k")
    assert c.get("t", "in", "k", store) is None
    return c.snapshot()


def tier_arena_fallback_keeps_counters(C, S):
    def drive(arena_mb):
        store = S.ObjectStore()
        c = C.SharedCache(C.CacheSpec(capacity_mb=4.0), arena_mb=arena_mb)
        for i in range(6):
            key = f"k{i}"
            store.put("in", key, bytes([i]) * (512 * 1024))
            c.get("t", "in", key, store)
            c.fill("t", "in", key, store.get("in", key), 512 * 1024,
                   hinted=True, etag=store.head("in", key).etag)
            c.get("t", "in", key, store)
        return c

    small, big = drive(0.25), drive(16.0)
    assert small.arena_fallbacks > 0 and big.arena_fallbacks == 0
    assert small.state.snapshot() == big.state.snapshot()
    return small.snapshot(), big.snapshot()


def tier_hits_are_immutable_copies(C, S):
    """Never torn: a hit is a copy; mutating it leaves the parked bytes."""
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    c.fill("t", "in", "k", store.get("in", "k"), 4096, hinted=True,
           etag=store.head("in", "k").etag)
    first = bytearray(c.get("t", "in", "k", store))
    first[:4] = b"zzzz"
    assert c.get("t", "in", "k", store) == b"x" * 4096
    return c.snapshot()


def tier_losing_racer(C, S):
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    v1, e1 = store.get_with_meta("in", "k")
    assert c.fill("t", "in", "k", v1, 4096, hinted=True, etag=e1.etag)
    store.put("in", "k", b"y" * 4096)
    v2, e2 = store.get_with_meta("in", "k")
    assert not c.fill("t", "in", "k", v2, 4096, hinted=True, etag=e2.etag)
    assert c.get("t", "in", "k", store) is None
    assert c.snapshot()["stale_invalidations"] == 1
    assert len(c._payload) == 0 and c._etag == {}
    return c.snapshot()


def tier_put_without_allocation(C, S):
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0, write_allocate=False))
    v1, m1 = store.get_with_meta("in", "k")
    c.fill("t", "in", "k", v1, 4096, hinted=True, etag=m1.etag)
    m2 = store.put("in", "k", b"y" * 4096)
    assert not c.put("t", "in", "k", b"y" * 4096, 4096, m2.etag)
    snap = c.snapshot()
    assert snap["entries"] == 0 and snap["used_bytes"] == 0
    assert c._payload == {} and c._etag == {}
    return snap


def tier_write_through_serves_the_new_version(C, S):
    """A durable overwrite written through replaces the entry: the next
    GET hits the new bytes under the new etag."""
    store = _store(S)
    c = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    v1, m1 = store.get_with_meta("in", "k")
    c.fill("t", "in", "k", v1, 4096, hinted=True, etag=m1.etag)
    m2 = store.put("in", "k", b"y" * 4096)
    assert c.put("t", "in", "k", b"y" * 4096, 4096, m2.etag)
    assert c.get("t", "in", "k", store) == b"y" * 4096
    return c.snapshot()


def tier_cross_tenant_dedup(C, S):
    store = _store(S)
    shared = C.SharedCache(C.CacheSpec(capacity_mb=1.0))
    private = C.SharedCache(C.CacheSpec(capacity_mb=1.0, cross_tenant=False))
    for c in (shared, private):
        data, etag = store.get("in", "k"), store.head("in", "k").etag
        c.fill("t1", "in", "k", data, 4096, hinted=True, etag=etag)
        c.fill("t2", "b2", "k", data, 4096, hinted=True, etag=etag)
    assert shared.snapshot()["unique_content"] == 1
    assert shared.snapshot()["dedup_bytes"] == 4096
    assert private.snapshot()["unique_content"] == 2
    assert private.snapshot()["dedup_bytes"] == 0
    return shared.snapshot(), private.snapshot()


TIER = [tier_fill_then_hit, tier_stale_etag_never_served,
        tier_deleted_object_invalidates, tier_arena_fallback_keeps_counters,
        tier_hits_are_immutable_copies, tier_losing_racer,
        tier_put_without_allocation,
        tier_write_through_serves_the_new_version, tier_cross_tenant_dedup]


@pytest.mark.parametrize("case", TIER, ids=lambda f: f.__name__[5:])
def test_shared_cache_tier_equals_reference(case):
    assert case(*PORT) == case(*REF)


# ------------------------------------------------------------ the nodes

@functools.lru_cache(maxsize=None)
def _payloads(scenario):
    return tuple(ref_serving.seed_payloads(scenario))


def _second_invocation(make_node, suite, scenario):
    node = make_node()
    try:
        node.deploy(suite[scenario])
        node.seed_input(scenario, payloads=_payloads(scenario))
        outs = []
        for _ in range(2):
            res = node.invoke(scenario).result(timeout=TIMEOUT)
            outs.append((bytes(node.store.get(
                "out", f"{res.invocation_id}-out")), res.response))
        node.drain(timeout_s=60.0)
        hits = (node.backend.stats["cache_hits"]
                if node.backend is not None else 0)
        return outs, node.cache_stats(), hits
    finally:
        node.shutdown()


@pytest.mark.parametrize("scenario", list(workloads.ML_SCENARIO_NAMES))
def test_second_invocation_hits_equal_reference(scenario):
    """Two invocations on one node: every stable GET (params, KV, weight
    shards, prompt) misses once and hits on the second invocation, with
    the same counters in both nodes."""
    spec = dict(capacity_mb=64.0)
    port = _second_invocation(
        lambda: runtime.WorkerNode("nexus", byte_scale=1.0, device="cpu",
                                   cache=cache.CacheSpec(**spec)),
        workloads.ml_suite("tiny"), scenario)
    ref = _second_invocation(
        lambda: ref_runtime.WorkerNode("nexus", byte_scale=1.0,
                                       cache=ref_cache.CacheSpec(**spec)),
        ref_workloads.ml_suite("tiny"), scenario)
    n_gets = len(workloads.ml_suite("tiny")[scenario].profile.gets)
    outs, stats, hits = port
    assert stats == ref[1] and hits == ref[2]
    assert stats["lookups"] == 2 * n_gets
    assert stats["hits"] == stats["misses"] == hits == n_gets
    assert outs[0] == outs[1]


def _client(F, M, admission):
    ctx = F.GuestContext(tenant="t", cred_handle="c", admission=admission)
    return F.NexusClient(ctx, lambda: None, M.CycleAccount())


@pytest.mark.parametrize("F,M", [(frontend, metrics),
                                 (ref_frontend, ref_metrics)],
                         ids=["port", "reference"])
def test_per_ordinal_admission(F, M):
    client = _client(F, M, {("b", "k"): [(True, True), (False, False)]})
    assert client._admission("b", "k") == (True, True)
    assert client._admission("b", "k") == (False, False)
    assert client._admission("b", "k") == (False, False)   # the last sticks
    assert _client(F, M, {})._admission("b", "k") == (False, True)


def _two_get_handler(event, ctx):
    a, b = event["inputs"]
    first = ctx.storage.get_object(Bucket=a["bucket"], Key=a["key"])
    second = ctx.storage.get_object(Bucket=b["bucket"], Key=b["key"])
    dst = event["outputs"][0]
    body = bytes(first["Body"])[:2048] + bytes(second["Body"])[:2048]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=body)
    return {"statusCode": 200}


def test_node_admission_flags_equal_reference():
    """The flags `_make_client` derives per GET ordinal, for a profile
    with a declared opt-out: equal in both nodes."""
    seen = {}
    for name, R, W in (("port", runtime, workloads),
                       ("ref", ref_runtime, ref_workloads)):
        prof = W.IOProfile((W.Get(4096), W.Get(4096, cacheable=False),
                            W.ComputeSegment(1.0), W.Put(4096)))
        w = W.Workload("TWO", prof, 8.0, _two_get_handler)
        kw = {"device": "cpu"} if R is runtime else {}
        node = R.WorkerNode("nexus", cache=(cache if R is runtime
                                            else ref_cache).CacheSpec(),
                            **kw)
        flags = []
        orig = node._make_client

        def spy(ctx, profile=None, orig=orig, flags=flags):
            orig(ctx, profile)
            flags.append({k: list(v) for k, v in
                          ctx.gctx.admission.items()})

        node._make_client = spy
        try:
            node.deploy(w)
            node.seed_input("TWO")
            node.invoke("TWO").result(timeout=TIMEOUT)
            seen[name] = (flags, node.cache_stats())
        finally:
            node.shutdown()
    assert seen["port"] == seen["ref"]
    (flags, stats) = seen["port"]
    assert list(flags[0].values()) == [[(True, True)], [(True, False)]]
    assert stats["lookups"] == 1        # the opted-out GET never looks


def test_crash_cannot_serve_stale_cached_bytes():
    """Overwrite a cached input in the store, then crash the backend: the
    next invocation must see the new bytes (hits revalidate the etag)."""
    import time
    spec = cache.CacheSpec(capacity_mb=32.0, admit="all", seed=5)
    node = runtime.WorkerNode("nexus", cache=spec, plan_stall_timeout_s=30.0,
                              device="cpu")
    suite = workloads.chaos_suite()
    name = next(iter(suite))
    try:
        node.deploy(suite[name])
        node.seed_input(name)
        node.invoke(name, inv_id="warm-0").result(timeout=60)
        before = dict(node.store.list_bucket("out"))
        for key, val in node.store.list_bucket("in").items():
            if key.startswith(name):
                node.store.put("in", key, b"\xff" * len(val))
        node.supervisor.kill_backend()
        deadline = time.monotonic() + 10.0
        while not node.backend._alive:
            assert time.monotonic() < deadline, "no restart"
            time.sleep(0.01)
        node.invoke(name, inv_id="probe-1").result(timeout=60)
        after = dict(node.store.list_bucket("out"))
        changed = [k for k in after if k not in before or after[k] != before[k]]
        assert changed, "the post-crash invocation served stale bytes"
        stats = node.cache_stats()
        assert stats["lookups"] > 0 and stats["stale_invalidations"] >= 1
    finally:
        node.shutdown()


def test_cacheless_node_reports_none():
    node = runtime.WorkerNode("nexus", device="cpu")
    try:
        assert node.cache_plane is None and node.cache_stats() is None
        assert node.backend.cache is None
    finally:
        node.shutdown()


# ------------------------------------------------- transparency, cache on

@functools.lru_cache(maxsize=None)
def _cached_runs(scenario, system):
    outs, stats, _ = _second_invocation(
        lambda: runtime.WorkerNode(system, byte_scale=1.0, device="cpu",
                                   cache=cache.CacheSpec(capacity_mb=64.0)),
        workloads.ml_suite("tiny"), scenario)
    return outs, stats


@pytest.mark.parametrize("scenario", list(workloads.ML_SCENARIO_NAMES))
def test_cached_outputs_identical_across_variants(scenario, monkeypatch):
    """With the cache on, the second invocation's GETs are served from
    the cache under every variant that offloads them, and every durable
    output is the same bytes: the port's core on the same payloads,
    within tolerance of the reference's core."""
    runs = {s: _cached_runs(scenario, s) for s in SYSTEMS}
    outs, _ = runs["nexus"]
    for system, (o, stats) in runs.items():
        assert o == outs, system
        if SYSTEMS[system].offload_sdk:
            assert stats["hits"] >= 1, system
        else:               # the coupled fabric never reaches the backend
            assert stats["lookups"] == 0, system
    body, response = outs[0]
    direct = serving.run_scenario(scenario, _payloads(scenario), device="cpu")
    if scenario == "LLM-DECODE":
        assert (body, response["token"]) == direct
    else:
        assert body == direct
    _assert_matches_reference(scenario, body, response.get("token"),
                              monkeypatch)
