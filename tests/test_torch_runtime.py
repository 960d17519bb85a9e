"""The port's worker-node runtime and MLServe handlers against the
reference's (`repro.core.runtime`, `repro.core.workloads`), on the CPU.

Every MLServe scenario runs under all 7 system variants through the
port's `WorkerNode(system, byte_scale=1.0, device="cpu")`, on the
reference's own seed payloads (the port cannot draw the reference's
``PRNGKey(0)`` params). What is held:

* durable outputs byte-identical across the variants and byte-equal to
  the port's core called directly on the same bytes;
* outputs within the cores' tolerance of the reference's
  (`test_torch_serving`: atol 0.3, rtol 0.05; a greedy token may flip
  only at a top-2 margin within 0.3, an expert choice only within the
  routing tolerance);
* the modeled books after one invocation equal the reference node's:
  every crossing count, every memory component, and the cycles per
  domain. No counter depends on wall time (compute is accounted at its
  modeled Mcycles, transfers at their byte counts), but several threads
  add floats into one domain in an order that varies from run to run,
  so cycles agree to a relative 1e-12 rather than bit for bit.
"""
import dataclasses
import functools
import inspect
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core import cache as ref_cache
from repro.core import des as ref_des
from repro.core import fabric as ref_fabric
from repro.core import faults as ref_faults
from repro.core import frontend as ref_frontend
from repro.core import guardrails as ref_guardrails
from repro.core import lifecycle as ref_lifecycle
from repro.core import metrics as ref_metrics
from repro.core import plan as ref_plan
from repro.core import runtime as ref_runtime
from repro.core import storage as ref_storage
from repro.core import streaming as ref_streaming
from repro.core import supervisor as ref_supervisor
from repro.core import workloads as ref_workloads
from repro.core.analysis import diag as ref_diag
from repro.core.analysis import infer as ref_infer
from repro.core.analysis import verify as ref_verify
from repro.core.arena import ArenaRegistry as RefArenaRegistry
from repro.models import serving as ref_serving
from repro_torch.core import (cache, des, fabric, faults, frontend,
                              guardrails, lifecycle, metrics, runtime,
                              storage, streaming, supervisor, workloads)
from repro_torch.core.analysis import diag, infer, verify
from repro_torch.core.runtime import WorkerNode
from repro_torch.core.workloads import (ComputeSegment, Get, IOProfile, Put,
                                        Workload)
from repro_torch.models import serving
from test_torch_model import ROUTE_TOL, RoutingSpy
from test_torch_serving import (TokenSpy, _assert_cache_close,
                                _assert_close_unless_excused, _np, _output,
                                TOL)

SYSTEMS = list(ref_plan.SYSTEMS)
SCENARIOS = list(ref_workloads.ML_SCENARIO_NAMES)
TIMEOUT = 120


@functools.lru_cache(maxsize=None)
def _ref_payloads(scenario):
    return tuple(ref_serving.seed_payloads(scenario))


def _durable(node, res, w):
    return [bytes(node.store.get(
        "out", f"{res.invocation_id}-out" + ("" if k == 0 else f"-{k}")))
        for k in range(len(w.profile.puts))]


def _run(node, suite, scenario, invocations=1):
    """Deploy, seed the reference's payloads, invoke; returns the node's
    (outputs, result) per invocation and its books, then shuts it down."""
    try:
        node.deploy(suite[scenario])
        node.seed_input(scenario, payloads=_ref_payloads(scenario))
        runs = []
        for _ in range(invocations):
            res = node.invoke(scenario).result(timeout=TIMEOUT)
            runs.append((_durable(node, res, suite[scenario]), res))
        return {"runs": runs, "acct": node.acct.snapshot(),
                "memory": dict(node.node_memory_mb().components)}
    finally:
        node.shutdown()


@functools.lru_cache(maxsize=None)
def _port_run(scenario, system):
    return _run(WorkerNode(system, byte_scale=1.0, device="cpu"),
                workloads.ml_suite("tiny"), scenario)


@functools.lru_cache(maxsize=None)
def _ref_run(scenario, system):
    return _run(ref_runtime.WorkerNode(system, byte_scale=1.0),
                ref_workloads.ml_suite("tiny"), scenario)


# ------------------------------------------------------------- the nodes

@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_node_matches_reference_node(system, scenario):
    """One cold invocation: the plan's breakdown groups, the declared
    output sizes, the response's fields, and the modeled books."""
    port, ref = _port_run(scenario, system), _ref_run(scenario, system)
    (outs, res), = port["runs"]
    (routs, rres), = ref["runs"]
    declared = [p.size_bytes
                for p in workloads.ml_suite("tiny")[scenario].profile.puts]
    assert [len(o) for o in outs] == [len(o) for o in routs] == declared
    assert res.cold and rres.cold
    assert set(res.breakdown) == set(rres.breakdown)
    assert res.response.keys() == rres.response.keys()
    assert res.response["statusCode"] == 200
    for key, value in res.response.items():
        if key != "token":      # a greedy choice, held in the next test
            assert value == rres.response[key], key
    assert all(e is not None for e in res.output_etags)
    acct, racct = port["acct"], ref["acct"]
    assert acct["crossings"] == racct["crossings"]
    assert acct["cycles"].keys() == racct["cycles"].keys()
    for domain, mcyc in acct["cycles"].items():
        assert mcyc == pytest.approx(racct["cycles"][domain], rel=1e-12)
    assert port["memory"] == ref["memory"]


def _assert_matches_reference(scenario, body, token, monkeypatch):
    """The reference's core on the same payloads, with the port's core
    beside it under the spies (its output is ``body``, byte for byte)."""
    payloads = _ref_payloads(scenario)
    if scenario == "MOE":
        ref = ref_serving.moe_infer(payloads)
        serving._bundle("moe")       # its meta-device pass before the spy
        spy = RoutingSpy(monkeypatch)
        b = ref_serving._bundle("moe")
        b["model"].prefill(ref_serving._load_params(
            "moe", b"".join(payloads)),
            {"tokens": ref_serving._prompt_tokens("moe")})
        assert serving.moe_infer(payloads, device="cpu") == body
        cfg = serving._bundle("moe")["cfg"]
        flipped = spy.flipped_rows(cfg.num_experts_per_tok, 1,
                                   ROUTE_TOL[cfg.dtype], coupled=True)
        _assert_close_unless_excused(_output("MOE", body),
                                     _output("MOE", ref), bool(flipped))
        return
    spy = TokenSpy(monkeypatch)
    if scenario == "LLM-COLD":
        ref = ref_serving.llm_cold(payloads[:-1], payloads[-1])
        assert serving.llm_cold(payloads[:-1], payloads[-1],
                                device="cpu") == body
        _assert_close_unless_excused(_output(scenario, body),
                                     _output(scenario, ref),
                                     not spy.same_tokens())
    elif scenario == "LLM-DECODE":
        ref, rtok = ref_serving.llm_decode(*payloads)
        assert serving.llm_decode(*payloads, device="cpu") == (body, token)
        _assert_cache_close(_output(scenario, body), _output(scenario, ref))
        if spy.same_tokens():
            assert token == rtok
    elif scenario == "LLM-PREFILL":
        ref = ref_serving.llm_prefill(*payloads)
        _assert_cache_close(_output(scenario, body), _output(scenario, ref))
    else:
        ref = ref_serving.emb_encode(*payloads)
        np.testing.assert_allclose(_np(_output(scenario, body)),
                                   _np(_output(scenario, ref)), **TOL)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_outputs_identical_across_variants_and_equal_the_core(
        scenario, monkeypatch):
    """Transparency: the same handler under every variant leaves the same
    durable bytes, which are the port's core's on the same payloads and
    within tolerance of the reference's."""
    bodies = {}
    for system in SYSTEMS:
        (outs, res), = _port_run(scenario, system)["runs"]
        bodies[system] = (outs, res.response)
    outs, response = bodies["nexus"]
    for system, (o, r) in bodies.items():
        assert o == outs, system
        assert r == response, system
    direct = serving.run_scenario(scenario, _ref_payloads(scenario),
                                  device="cpu")
    if scenario == "LLM-DECODE":
        assert (outs[0], response["token"]) == direct
    else:
        assert outs[0] == direct
    _assert_matches_reference(scenario, outs[0], response.get("token"),
                              monkeypatch)


def test_decode_kv_round_trip_is_bit_exact():
    """The KV cache written back by the LLM-DECODE handler equals a direct
    core call on the same seed state: the platform moved the tensors, it
    never touched them (port copy of the reference's test, on the port's
    own seed payloads)."""
    payloads = serving.seed_payloads("LLM-DECODE", device="cpu")
    kv_direct, token_direct = serving.llm_decode(*payloads, device="cpu")
    node = WorkerNode("nexus", byte_scale=1.0, device="cpu")
    try:
        node.deploy(workloads.ml_suite("tiny")["LLM-DECODE"])
        node.seed_input("LLM-DECODE", payloads=payloads)
        res = node.invoke("LLM-DECODE").result(timeout=TIMEOUT)
        assert _durable(node, res, workloads.ml_suite("tiny")["LLM-DECODE"]
                        ) == [kv_direct]
        assert res.response["token"] == token_direct
    finally:
        node.shutdown()


@pytest.mark.parametrize("system", ["nexus", "baseline"])
def test_warm_invocation_reads_fresh_bytes(system):
    """Two invocations on one node: the second reuses the instance (and,
    under Nexus, the arena the first one's views pointed into, released
    after it) and still gives the core's bytes."""
    suite = workloads.ml_suite("tiny")
    node = WorkerNode(system, byte_scale=1.0, device="cpu")
    out = _run(node, suite, "LLM-COLD", invocations=2)
    (first, r1), (second, r2) = out["runs"]
    payloads = _ref_payloads("LLM-COLD")
    assert (r1.cold, r2.cold) == (True, False)
    assert first == second == [serving.llm_cold(payloads[:-1], payloads[-1],
                                                device="cpu")]


def test_opaque_input_streams_through_the_ring():
    """A size-opaque first input cannot be prefetched: the guest stub
    streams it through the backend's circular buffer, and the handler
    sees the same bytes."""
    suite = workloads.ml_suite("tiny")
    node = WorkerNode("nexus", byte_scale=1.0, device="cpu")
    try:
        node.deploy(suite["EMB"])
        node.seed_input("EMB", payloads=_ref_payloads("EMB"))
        res = node.invoke("EMB", opaque=True).result(timeout=TIMEOUT)
        assert node.backend.stats["stream_gets"] == 2
        assert node.backend.stats["prefetches"] == 0
        direct = serving.emb_encode(*_ref_payloads("EMB"), device="cpu")
        assert _durable(node, res, suite["EMB"]) == [direct]
    finally:
        node.shutdown()


@pytest.mark.parametrize("system", ["nexus-tcp", "baseline"])
def test_transient_storage_failures_are_retried_or_surface(system):
    """`faults=` reaches remote storage: every second op fails once.
    The Nexus stub retries behind the backend and the output stands; the
    coupled client has no retry loop, so the invocation fails."""
    suite = workloads.ml_suite("tiny")
    node = WorkerNode(system, byte_scale=1.0, device="cpu",
                      faults=storage.FaultPlan(fail_every=2))
    try:
        node.deploy(suite["LLM-PREFILL"])
        node.seed_input("LLM-PREFILL",
                        payloads=_ref_payloads("LLM-PREFILL"))
        fut = node.invoke("LLM-PREFILL")
        if system == "baseline":
            with pytest.raises(ConnectionError, match="transient"):
                fut.result(timeout=TIMEOUT)
            return
        res = fut.result(timeout=TIMEOUT)
        assert node.remote.transient_failures >= 1
        assert _durable(node, res, suite["LLM-PREFILL"]) == [
            serving.llm_prefill(*_ref_payloads("LLM-PREFILL"), device="cpu")]
    finally:
        node.shutdown()


def test_dropped_ack_is_redriven_from_the_dedup_record():
    """A FaultHooks ack drop: the write is durable, its ack is lost, the
    response gate's wait times out and the idempotent redrive resolves
    it without moving the bytes again."""
    suite = workloads.ml_suite("tiny")
    node = WorkerNode("nexus", byte_scale=1.0, device="cpu",
                      writeback_ack_timeout_s=2.0)
    dropped = []

    def drop_once(key):
        if dropped:
            return False
        dropped.append(key)
        return True

    node.fault_hooks.ack_drop = drop_once
    try:
        node.deploy(suite["EMB"])
        node.seed_input("EMB", payloads=_ref_payloads("EMB"))
        res = node.invoke("EMB").result(timeout=TIMEOUT)
        assert len(dropped) == 1
        assert node.backend.stats["acks_dropped"] == 1
        assert node.backend.stats["dedup_hits"] == 1
        assert res.output_etag is not None
    finally:
        node.shutdown()


def test_guest_waits_for_the_prefetch_as_long_as_the_node_allows():
    """The stub's first GET waits ``prefetch_timeout_s`` (the node's
    ``connect_timeout_s``) for the ingress prefetch, not a fixed 30 s."""
    from repro_torch.core.arena import TenantArena
    from repro_torch.core.backend import PrefetchHandle
    from repro_torch.core.hints import InputHint

    def client(timeout_s):
        handle = PrefetchHandle(InputHint("in", "k", 3))
        slot = TenantArena("t", 1.0).alloc(3)
        slot.write(b"abc")
        handle.slot = slot
        threading.Timer(0.3, handle.ready.set).start()
        ctx = frontend.GuestContext("t", "cred", prefetch=handle)
        return frontend.NexusClient(ctx, lambda: None, metrics.CycleAccount(),
                                    prefetch_timeout_s=timeout_s)

    with pytest.raises(TimeoutError, match="prefetch of k timed out"):
        client(0.05).get_object(Bucket="in", Key="k")
    stub = client(5.0)
    stub._charge_stub_call = lambda sdk, nbytes: None
    assert bytes(stub.get_object(Bucket="in", Key="k")["Body"]) == b"abc"


# -------------------------------------------------- contracts (port copies)

def _greedy(event, ctx):
    src, dst = event["inputs"][0], event["outputs"][0]
    obj = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                           Body=bytes(obj["Body"]))
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"] + "-x",
                           Body=b"undeclared")


def _lazy(event, ctx):
    return {"statusCode": 204}              # never touches storage


def _clobber(event, ctx):
    dst = event["outputs"][0]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                           Body=b"A" * 1024)
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                           Body=b"B" * 1024)


class TestProfileContract:
    """Port copies of the reference's `TestProfileContract`: the
    IOProfile is enforced at deploy (ProfileInfer) and, with
    ``static_check=False``, at invoke by the `_GuestRun` shim."""

    GREEDY = Workload("GREEDY", IOProfile.single(0.1, 0.1, 5.0), 30.0,
                      _greedy)
    LAZY = Workload("LAZY", IOProfile((Get(64 * 1024),
                                       ComputeSegment(2.0),
                                       Put(64 * 1024))), 30.0, _lazy,
                    deterministic_input=False)
    CLOBBER = Workload("CLOBBER", IOProfile((Put(1024), Put(1024))),
                       30.0, _clobber, deterministic_input=False)

    @staticmethod
    def _node(system, **kw):
        return WorkerNode(system, device="cpu", **kw)

    def test_exceeding_profile_rejected_at_deploy(self):
        node = self._node("nexus")
        try:
            with pytest.raises(RuntimeError, match="IOProfile"):
                node.deploy(self.GREEDY)
        finally:
            node.shutdown()

    def test_exceeding_profile_fails_at_invoke(self):
        node = self._node("nexus", static_check=False)
        try:
            node.deploy(self.GREEDY)
            node.seed_input("GREEDY")
            with pytest.raises(RuntimeError, match="IOProfile"):
                node.invoke("GREEDY").result(timeout=60)
        finally:
            node.shutdown()

    def test_underperforming_profile_rejected_at_deploy(self):
        node = self._node("baseline")
        try:
            with pytest.raises(RuntimeError, match="IOProfile"):
                node.deploy(self.LAZY)
        finally:
            node.shutdown()

    def test_underperforming_profile_fails_at_invoke(self):
        node = self._node("baseline", static_check=False)
        try:
            node.deploy(self.LAZY)
            node.seed_input("LAZY")
            with pytest.raises(RuntimeError, match="unperformed"):
                node.invoke("LAZY").result(timeout=60)
        finally:
            node.shutdown()

    @pytest.mark.parametrize("system", ["baseline", "nexus"])
    def test_duplicate_output_key_rejected_at_deploy(self, system):
        node = self._node(system)
        try:
            with pytest.raises(RuntimeError, match="same"):
                node.deploy(self.CLOBBER)
        finally:
            node.shutdown()

    @pytest.mark.parametrize("system", ["baseline", "nexus"])
    def test_duplicate_output_key_rejected_at_invoke(self, system):
        node = self._node(system, static_check=False)
        try:
            node.deploy(self.CLOBBER)
            with pytest.raises(RuntimeError, match="twice"):
                node.invoke("CLOBBER").result(timeout=60)
        finally:
            node.shutdown()

    def test_out_of_order_gets_reclaim_the_prefetch_slot(self):
        def reversed_reader(event, ctx):
            h = []
            for src in reversed(event["inputs"]):
                obj = ctx.storage.get_object(Bucket=src["bucket"],
                                             Key=src["key"])
                h.append(bytes(obj["Body"][:8]))
            dst = event["outputs"][0]
            ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                                   Body=b"".join(h))

        w = Workload("REV", IOProfile((Get(256 * 1024), Get(256 * 1024),
                                       ComputeSegment(2.0), Put(64))),
                     30.0, reversed_reader)
        node = self._node("nexus")
        try:
            node.deploy(w)
            node.seed_input("REV")
            for _ in range(3):
                res = node.invoke("REV").result(timeout=60)
                assert res.output_etag is not None
            assert node.backend.arenas.get("REV").utilization() == 0.0
        finally:
            node.shutdown()


def test_handlers_issue_the_reference_handlers_storage_calls():
    """ProfileInfer recovers, from each port handler, the reference
    handler's storage calls in the same order, with the same symbolic
    buckets and keys."""
    port, ref = workloads.ml_suite("tiny"), ref_workloads.ml_suite("tiny")
    for name in SCENARIOS:
        n_in = len(ref[name].profile.gets)
        n_out = len(ref[name].profile.puts)
        got = infer.infer_handler(port[name].handler, n_in, n_out)
        want = ref_infer.infer_handler(ref[name].handler, n_in, n_out)
        assert [(o.kind, o.method, o.bucket, o.key) for o in got.ops] == [
            (o.kind, o.method, o.bucket, o.key) for o in want.ops], name
        assert got.errors == [] and want.errors == []
        assert infer.check_workload(port[name]).kinds == (
            port[name].profile.io_kinds)


# ------------------------------------------------------------- guardrails

def test_guardrail_shed_is_typed_and_counted():
    """A best-effort class with a one-token bucket: the first invocation
    is admitted, the second shed before any work, with the reference's
    decision."""
    def policy(gr):
        return gr.GuardrailPolicy(
            admission=gr.AdmissionSpec(rate_per_s=1e-3, burst=1.0),
            classes=(gr.SloClass("be", priority=0),), default_class="be")

    node = WorkerNode("nexus", byte_scale=1.0, device="cpu",
                      guardrails=policy(guardrails))
    try:
        node.deploy(workloads.ml_suite("tiny")["EMB"])
        node.seed_input("EMB", payloads=_ref_payloads("EMB"))
        assert node.invoke("EMB").result(timeout=TIMEOUT).output_etag
        with pytest.raises(guardrails.Rejected, match="admission"):
            node.invoke("EMB")
        assert node.acct.snapshot()["crossings"]["shed"] == 1
        assert node.guard.shed["admission"] == 1
        node.drain(timeout_s=10)
        with pytest.raises(guardrails.Rejected, match="drain"):
            node.invoke("EMB")
        node.resume()
    finally:
        node.shutdown()
    now = [0.0]
    states = [mod.GuardState(policy(mod), clock=lambda: now[0])
              for mod in (guardrails, ref_guardrails)]
    for t in (0.0, 0.1, 500.0, 1000.0, 1000.5, 2500.0):
        now[0] = t
        got, want = (s.decide("EMB", "EMB", 0.2) for s in states)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), t


@pytest.mark.parametrize("key", ["", "inv-1", "inv-2:ack"])
def test_backoff_delays_equal_reference(key):
    for spec in ({}, {"max_attempts": 5, "backoff_base_s": 0.01,
                      "jitter_frac": 0.5}):
        assert guardrails.backoff_delays(
            guardrails.RetrySpec(**spec), key) == ref_guardrails.backoff_delays(
            ref_guardrails.RetrySpec(**spec), key)


# ------------------------------------------------------ defaults, constants

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_node_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerNode("nexus")
    node = WorkerNode("nexus", device="cpu")
    try:
        assert node.device == torch.device("cpu")
    finally:
        node.shutdown()


def test_node_arena_cache_and_registry_deviations():
    """``arena_mb`` defaults to the reference's arena size and reaches
    the tenant arenas; a cache spec builds the node's SharedCache plane
    (sized as the reference sizes it) and reaches the backend; deploying
    by name finds the paper suite, and an unknown name raises
    `KeyError`, as in the reference."""
    default = inspect.signature(WorkerNode).parameters["arena_mb"].default
    ref_default = inspect.signature(RefArenaRegistry).parameters[
        "capacity_mb"].default
    assert default == ref_default == 64.0
    node = WorkerNode("nexus", device="cpu", arena_mb=2.5)
    try:
        node.deploy(workloads.ml_suite("tiny")["EMB"])
        assert node.backend.arenas.get("EMB").capacity == int(2.5 * 2 ** 20)
        node.deploy("WEB")
        with pytest.raises(KeyError):
            node.deploy("NOT-A-FUNCTION")
        assert node.cache_plane is None and node.cache_stats() is None
    finally:
        node.shutdown()
    spec = cache.CacheSpec(capacity_mb=8.0)
    node = WorkerNode("nexus", device="cpu", cache=spec)
    ref = ref_runtime.WorkerNode("nexus", cache=ref_cache.CacheSpec(
        capacity_mb=8.0))
    try:
        assert node.cache_plane.spec == spec
        assert node.backend.cache is node.cache_plane
        assert (node.cache_plane._arenas._capacity_mb
                == ref.cache_plane._arenas._capacity_mb)
        assert node.cache_stats() == ref.cache_stats()
    finally:
        node.shutdown()
        ref.shutdown()


def _defaults(fn):
    return {n: p.default for n, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_signature_defaults_equal_reference():
    """Every keyword default the copies share with the reference."""
    port_node = _defaults(WorkerNode)
    for name in ("device", "arena_mb"):
        port_node.pop(name)
    assert port_node == _defaults(ref_runtime.WorkerNode)
    pairs = [
        (frontend.NexusClient, ref_frontend.NexusClient),
        (frontend.BaselineClient, ref_frontend.BaselineClient),
        (supervisor.Supervisor, ref_supervisor.Supervisor),
        (streaming.CircularBuffer, ref_streaming.CircularBuffer),
        (storage.RemoteStorage, ref_storage.RemoteStorage),
        (lifecycle.InstancePool, ref_lifecycle.InstancePool),
        (lifecycle.FunctionInstance, ref_lifecycle.FunctionInstance),
        (metrics.CycleAccount, ref_metrics.CycleAccount),
    ]
    for port_fn, ref_fn in pairs:
        port = _defaults(port_fn)
        if port_fn is frontend.NexusClient:
            # the reference's stub waits a fixed 30 s for the prefetch
            assert port.pop("prefetch_timeout_s") == 30.0
        assert port == _defaults(ref_fn), port_fn


def _upper(mod):
    """A module's upper-case names: its constants, and the aliases of
    modules and the caches that are not constants."""
    return {n: getattr(mod, n) for n in dir(mod)
            if n.isupper() and not n.startswith("__")
            and not isinstance(getattr(mod, n), types.ModuleType)
            and n != "_CHECK_CACHE"}


@pytest.mark.parametrize("port_mod,ref_mod", [
    (fabric, ref_fabric), (metrics, ref_metrics), (storage, ref_storage),
    (streaming, ref_streaming), (guardrails, ref_guardrails),
    (workloads, ref_workloads), (runtime, ref_runtime),
    (frontend, ref_frontend), (diag, ref_diag), (infer, ref_infer),
    (lifecycle, ref_lifecycle), (faults, ref_faults), (cache, ref_cache),
    (verify, ref_verify),
], ids=lambda m: getattr(m, "__name__", "").rsplit(".", 1)[-1])
def test_copied_constants_equal_reference(port_mod, ref_mod):
    """Every upper-case module constant a copy keeps has the reference's
    value (a copy may keep fewer). None has one of its own: PlanVerify
    keeps no copy of the DES opcodes, and reads the port's `des`'s,
    which equal the reference DES's."""
    port, ref = _upper(port_mod), _upper(ref_mod)
    if port_mod is verify:
        assert not {"_OP_WIRE", "_OP_CACHE"} & port.keys()
        assert not hasattr(verify, "_OP_WIRE")
        assert not hasattr(verify, "_OP_CACHE")
        assert (des._OP_WIRE, des._OP_CACHE) == (ref_des._OP_WIRE,
                                                 ref_des._OP_CACHE)
    own = {n for n in port if n not in ref}
    assert not own, own
    for name, value in port.items():
        assert _plain(value) == _plain(ref[name]), name


def _plain(value):
    """Dataclass instances as (class name, fields), so the copies' values
    compare with the reference's; a handler as its name (the two packages
    hold two function objects of one body)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value).__name__, {
            f.name: _plain(getattr(value, f.name))
            for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, types.FunctionType):
        return value.__qualname__
    return value


def test_fault_and_policy_dataclasses_equal_reference():
    for port_cls, ref_cls in [
            (storage.FaultPlan, ref_storage.FaultPlan),
            (faults.FaultHooks, ref_faults.FaultHooks),
            (guardrails.RetrySpec, ref_guardrails.RetrySpec),
            (guardrails.BreakerSpec, ref_guardrails.BreakerSpec),
            (guardrails.GuardrailPolicy, ref_guardrails.GuardrailPolicy),
            (frontend.HandlerContext, ref_frontend.HandlerContext),
            (frontend.GuestContext, ref_frontend.GuestContext),
            (cache.CacheSpec, ref_cache.CacheSpec),
            (faults.FaultSpec, ref_faults.FaultSpec),
            (faults.FaultSchedule, ref_faults.FaultSchedule),
            (workloads.ArrivalPattern, ref_workloads.ArrivalPattern)]:
        fields = {f.name: f.default for f in dataclasses.fields(port_cls)}
        if port_cls is frontend.HandlerContext:
            assert fields.pop("device") is None
        want = {f.name: f.default for f in dataclasses.fields(ref_cls)}
        assert fields == want, port_cls
    assert frontend.S3_METHODS == ref_frontend.S3_METHODS
    assert guardrails.GuardrailPolicy().is_empty


def test_instance_memory_and_fabric_costs_equal_reference():
    for variant in ("baseline", "nexus-sdk-only", "nexus", "wasm"):
        for mb in (0.0, 42.0, 300.0):
            got = fabric.instance_memory(mb, variant)
            want = ref_fabric.instance_memory(mb, variant)
            assert got.components == want.components
            assert (fabric.restore_seconds_components(got)
                    == ref_fabric.restore_seconds_components(want))
    for nbytes in (0, 4096, 16_060_522_496):
        for sdk, lang in (("aws", "py"), ("minio", "go")):
            for name in ("in_guest_op_cost", "in_process_op_cost"):
                assert (dataclasses.asdict(getattr(fabric, name)(
                    sdk, lang, nbytes)) == dataclasses.asdict(
                    getattr(ref_fabric, name)(sdk, lang, nbytes)))
        assert (dataclasses.asdict(fabric.remoted_op_cost("aws", nbytes))
                == dataclasses.asdict(ref_fabric.remoted_op_cost("aws",
                                                                 nbytes)))


def test_metrics_extensions_follow_reference():
    accts = []
    for m in (metrics, ref_metrics):
        a, b = m.CycleAccount(), m.CycleAccount()
        a.charge(m.GUEST_USER, 1.5)
        b.charge(m.HOST_USER, 2.0)
        b.cross(m.CTRL_MSG, 3)
        a.merge(b)
        snap = a.snapshot()
        b.reset()
        assert b.snapshot()["total"] == 0
        lat = m.LatencyTrace()
        for x in (0.1, 0.3):
            lat.record("f:cold", x)
        mem = m.MemoryAccount()
        mem.add("guest_os", 52.0)
        mem.add("workload", 42.0)
        accts.append((snap, lat.mean("f:cold"), lat.count("f:cold"),
                      lat.labels(), mem.total(), mem.share("workload")))
    assert accts[0] == accts[1]
    assert (metrics.CTRL_MSG, metrics.RETRY, metrics.SHED) == (
        ref_metrics.CTRL_MSG, ref_metrics.RETRY, ref_metrics.SHED)


def test_circular_buffer_round_trip_and_failure():
    buf = streaming.CircularBuffer(capacity=1024)
    data = bytes(range(256)) * 20
    closed = []
    buf.on_close = lambda b: closed.append(b.total_in)

    def pump():
        for off in range(0, len(data), 300):
            buf.write(data[off:off + 300])
        buf.close()

    t = threading.Thread(target=pump)
    t.start()
    assert buf.read_all(chunk=100) == data
    t.join(timeout=10)
    assert not t.is_alive() and closed == [len(data)]
    bad = streaming.CircularBuffer(capacity=64)
    bad.write(b"abc")
    bad.fail(ConnectionError("pump died"))
    assert bad.read(10) == b"abc"
    with pytest.raises(ConnectionError, match="pump died"):
        bad.read(10)


# ----------------------------------------------------------- scale choice

def test_core_scale_follows_the_payload_length():
    """The cores find their scale from the params payload (or its first
    shard): the tiny and the full config's lengths, nothing else."""
    tiny = serving.role_sizes(serving._bundle("llm", "tiny")["cfg"])
    full = serving.role_sizes(serving._bundle("llm", "full")["cfg"])
    assert serving._scale_of("llm", tiny["params_bytes"]) == "tiny"
    assert serving._scale_of("llm", full["params_bytes"]) == "full"
    first = serving.shard_bytes(full["params_bytes"], 4)[0]
    assert serving._scale_of("llm", first, 4) == "full"
    with pytest.raises(ValueError, match="neither the tiny nor the full"):
        serving._scale_of("llm", full["params_bytes"] + 1)
    params, prompt = _ref_payloads("LLM-PREFILL")
    with pytest.raises(ValueError, match="neither the tiny nor the full"):
        serving.llm_prefill(params + b"\0", prompt, device="cpu")


def test_handler_errors_fail_the_invocation_future():
    """A core that raises fails its invocation's future: the platform
    never answers for a handler that did not finish."""
    suite = workloads.ml_suite("tiny")
    node = WorkerNode("nexus", byte_scale=1.0, device="cpu")
    try:
        node.deploy(suite["LLM-PREFILL"])
        params, prompt = _ref_payloads("LLM-PREFILL")
        node.seed_input("LLM-PREFILL", payloads=[params + b"\0", prompt])
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="neither the tiny"):
            node.invoke("LLM-PREFILL").result(timeout=TIMEOUT)
        assert time.monotonic() - t0 < TIMEOUT
    finally:
        node.shutdown()
