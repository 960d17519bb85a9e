"""The paper suite, the multi-I/O scenarios and the chaos suite
(`repro_torch.core.workloads`) through the port's worker node, against
the reference's (`repro.core.workloads`, `repro.core.runtime`), on the
CPU.

One node per system variant deploys every `SUITE` function and every
`SCENARIOS` entry by name (`REGISTRY`) and both `chaos_suite` functions
as values, seeds each with the node's own filler inputs, and invokes all
of them at once, cold, then all again, warm. The reference's node does
the same. What is held:

* the suite itself: names, profiles, libs and the arrival patterns equal
  the reference's, and the handlers' outputs on the same input are the
  same bytes;
* per function and variant: the durable outputs of both invocations are
  byte-equal to the reference node's, the response is the reference's,
  the invocation is cold then warm, and the breakdown has the
  reference's groups; per function, the outputs are byte-identical
  across the 7 variants;
* per variant: the node's modeled books after both rounds equal the
  reference node's (crossings and memory exactly; cycles to a relative
  1e-12, since threads add floats into one domain in varying order);
* per function, variant and coldness: the modeled phase durations and
  the unloaded latency equal the reference's.
"""
import dataclasses
import functools

import pytest

from repro.core import plan as ref_plan
from repro.core import runtime as ref_runtime
from repro.core import workloads as ref_workloads
from repro_torch.core import plan, runtime, workloads

SYSTEMS = list(ref_plan.SYSTEMS)
NAMES = list(ref_workloads.REGISTRY) + list(ref_workloads.chaos_suite())
TIMEOUT = 60


def _suite(W):
    return {**W.REGISTRY, **W.chaos_suite()}


def _durable(node, inv_id, w):
    return [bytes(node.store.get(
        "out", f"{inv_id}-out" + ("" if k == 0 else f"-{k}")))
        for k in range(len(w.profile.puts))]


def _drive(node, W):
    """Deploy everything, invoke everything cold and then warm, all
    functions of a round at once; returns each function's rounds and the
    node's books."""
    suite = _suite(W)
    try:
        for name, w in suite.items():
            node.deploy(name if name in W.REGISTRY else w)
            node.seed_input(name)
        rounds = {name: [] for name in suite}
        for run in ("cold", "warm"):
            futs = {name: node.invoke(name, inv_id=f"{name}-{run}")
                    for name in suite}
            for name, fut in futs.items():
                res = fut.result(timeout=TIMEOUT)
                rounds[name].append((_durable(node, res.invocation_id,
                                              suite[name]), res))
        node.drain(timeout_s=30.0)
        return {"rounds": rounds, "acct": node.acct.snapshot(),
                "memory": dict(node.node_memory_mb().components)}
    finally:
        node.shutdown()


@functools.lru_cache(maxsize=None)
def _port(system):
    return _drive(runtime.WorkerNode(system, device="cpu"), workloads)


@functools.lru_cache(maxsize=None)
def _ref(system):
    return _drive(ref_runtime.WorkerNode(system), ref_workloads)


# ------------------------------------------------------------- the suite

def _profile_ops(w):
    return [dataclasses.asdict(op) | {"type": type(op).__name__}
            for op in w.profile.ops]


def test_suite_equals_reference():
    assert workloads.NAMES == ref_workloads.NAMES
    assert workloads.SCENARIO_NAMES == ref_workloads.SCENARIO_NAMES
    assert list(workloads.REGISTRY) == list(ref_workloads.REGISTRY)
    assert workloads.balanced_mix() == ref_workloads.balanced_mix()
    for name in NAMES:
        w, rw = _suite(workloads)[name], _suite(ref_workloads)[name]
        assert _profile_ops(w) == _profile_ops(rw), name
        assert (w.extra_libs_mb, w.deterministic_input) == (
            rw.extra_libs_mb, rw.deterministic_input), name
        assert workloads.compute_io_ratio(w) == \
            ref_workloads.compute_io_ratio(rw)
    # the ML suite stays out of the deployable set, as in the reference
    assert not set(workloads.ML_SCENARIO_NAMES) & set(workloads.REGISTRY)


def test_arrival_patterns_equal_reference():
    assert ({k: dataclasses.asdict(v)
             for k, v in workloads.ARRIVAL_PATTERNS.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_workloads.ARRIVAL_PATTERNS.items()})
    for name in workloads.ARRIVAL_PATTERNS:
        assert workloads.resolve_pattern(name).name == name
    mine = workloads.ArrivalPattern("mine", kind="diurnal", amplitude=0.3)
    assert workloads.resolve_pattern(mine) is mine
    with pytest.raises(KeyError, match="unknown arrival pattern"):
        workloads.resolve_pattern("weekly")
    for bad in ({"kind": "gamma"}, {"amplitude": 1.0},
                {"burst_factor": 0.0}, {"burst_fraction": 1.0},
                {"period_s": 0.0}):
        for W in (workloads, ref_workloads):
            with pytest.raises(ValueError):
                W.ArrivalPattern("bad", **bad)


class _Store:
    """The smallest storage surface a handler needs: fixed inputs in,
    outputs recorded."""

    def __init__(self, payload):
        self.payload, self.puts = payload, []

    def get_object(self, Bucket, Key):
        return {"Body": memoryview(self.payload)}

    def put_object(self, Bucket, Key, Body):
        self.puts.append((Key, bytes(Body)))


@pytest.mark.parametrize("name", NAMES)
def test_handler_bodies_equal_reference(name):
    """Each handler called directly on the same input bytes: the same
    PUTs and the same response."""
    w, rw = _suite(workloads)[name], _suite(ref_workloads)[name]
    payload = bytes(range(256)) * 512
    event = {"inputs": [{"bucket": "in", "key": f"i{k}"}
                        for k in range(len(w.profile.gets))],
             "outputs": [{"bucket": "out", "key": f"o{k}"}
                         for k in range(len(w.profile.puts))]}
    out = {}
    for tag, fn in (("port", w.handler), ("ref", rw.handler)):
        st = _Store(payload)
        ctx = type("Ctx", (), {"storage": st})()
        out[tag] = (fn(event, ctx), st.puts)
    assert out["port"] == out["ref"]
    assert len(out["port"][1]) == len(w.profile.puts)


# ------------------------------------------------------------- the nodes

@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("name", NAMES)
def test_node_runs_equal_reference(name, system):
    port, ref = _port(system)["rounds"][name], _ref(system)["rounds"][name]
    for (outs, res), (routs, rres), cold in zip(port, ref, (True, False)):
        assert outs == routs
        assert res.response == rres.response
        assert res.cold == rres.cold == cold
        assert set(res.breakdown) == set(rres.breakdown)
        assert all(e is not None for e in res.output_etags)
    assert port[0][0] == port[1][0]


@pytest.mark.parametrize("name", NAMES)
def test_outputs_identical_across_variants(name):
    outs = {system: _port(system)["rounds"][name][0][0]
            for system in SYSTEMS}
    first = outs[SYSTEMS[0]]
    assert all(o == first for o in outs.values()), name
    assert len(first) == len(_suite(workloads)[name].profile.puts)
    assert all(first)


@pytest.mark.parametrize("system", SYSTEMS)
def test_node_books_equal_reference(system):
    port, ref = _port(system), _ref(system)
    assert port["acct"]["crossings"] == ref["acct"]["crossings"]
    assert port["acct"]["cycles"].keys() == ref["acct"]["cycles"].keys()
    for domain, mcyc in port["acct"]["cycles"].items():
        assert mcyc == pytest.approx(ref["acct"]["cycles"][domain],
                                     rel=1e-12), domain
    assert port["memory"] == ref["memory"]


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("name", NAMES)
def test_phase_durations_equal_reference(name, system):
    w, rw = _suite(workloads)[name], _suite(ref_workloads)[name]
    spec, rspec = plan.SYSTEMS[system], ref_plan.SYSTEMS[system]
    for cold in (True, False):
        assert (plan.duration_vector(spec, w, cold)
                == ref_plan.duration_vector(rspec, rw, cold))
    assert plan.unloaded_latency(spec, w) == ref_plan.unloaded_latency(
        rspec, rw)
