"""The density simulator's small dependencies in the port
(`repro_torch.core.{planes,trace,fluid}` and `GuardrailPolicy.scaled`)
against the reference's, on the CPU.

What is held:

* the vsock control plane: port copies of the reference's
  `tests/test_planes.py` (the 4 KB descriptor bound, the per-message
  cycle and crossing charges, the synchronous `call`/`reply`), plus its
  constants and message sizes equal to the reference's;
* `trace`: per-function rates and arrival streams equal to the
  reference's, float for float, for fixed seeds under no pattern and
  under every `ArrivalPattern`; the merged feed, the offered load and
  the inter-arrival CV too;
* `fluid`: `fluid_passes` and `fluid_first_fail` equal to the
  reference's on the paper suite, for every variant;
* `GuardrailPolicy.scaled` equal to the reference's field for field.
"""
import dataclasses
import queue
import threading

import pytest

from repro.core import fluid as ref_fluid
from repro.core import guardrails as ref_GR
from repro.core import planes as ref_planes
from repro.core import trace as ref_trace
from repro.core import workloads as ref_W
from repro_torch.core import fabric as F
from repro_torch.core import fluid
from repro_torch.core import guardrails as GR
from repro_torch.core import metrics as M
from repro_torch.core import planes
from repro_torch.core import trace
from repro_torch.core import workloads as W
from repro_torch.core.planes import (CTRL_MSG_MAX_BYTES, ControlMessage,
                                     ControlPlane, call, reply)
from repro_torch.core.plan import SYSTEMS

ALL_SYSTEMS = tuple(SYSTEMS)


def _plane(depth: int = 256):
    acct = M.CycleAccount()
    return ControlPlane(acct, depth=depth), acct


# ------------------------------------------------------------- planes

class TestControlMessage:
    def test_approx_size_counts_header_and_body(self):
        empty = ControlMessage("invoke", "tenant-a")
        assert empty.approx_size() == 64
        msg = ControlMessage("get", "tenant-a",
                             body={"bucket": "warm", "key": "object-1"})
        assert msg.approx_size() == 64 + len("bucket") + len("warm") \
            + len("key") + len("object-1")

    @pytest.mark.parametrize("body", [None, {}, {"bucket": "warm"},
                                      {"k": "y" * 4000, "n": 12}])
    def test_size_and_bound_equal_reference(self, body):
        kw = {} if body is None else {"body": body}
        port = ControlMessage("put", "tenant-a", **kw)
        ref = ref_planes.ControlMessage("put", "tenant-a", **kw)
        assert port.approx_size() == ref.approx_size()
        assert CTRL_MSG_MAX_BYTES == ref_planes.CTRL_MSG_MAX_BYTES


class TestControlPlane:
    def test_send_recv_roundtrip_in_order(self):
        plane, _ = _plane()
        sent = [ControlMessage("invoke", "t", body={"i": i})
                for i in range(5)]
        for m in sent:
            plane.send(m)
        assert plane.sent == 5
        assert [plane.recv(timeout=1.0) for _ in range(5)] == sent

    def test_send_charges_vsock_costs_per_message(self):
        """Every descriptor charges the fabric's vsock cycle model to
        the two kernel domains and counts kick+completion exits plus
        one control-plane crossing — per MESSAGE, not per byte."""
        plane, acct = _plane()
        n = 7
        for i in range(n):
            plane.send(ControlMessage("complete", "t", body={"i": i}))
        snap = acct.snapshot()
        assert snap["cycles"][M.GUEST_KERNEL] == pytest.approx(
            n * F.VSOCK_GUEST_KERNEL_MCYC)
        assert snap["cycles"][M.HOST_KERNEL] == pytest.approx(
            n * F.VSOCK_HOST_KERNEL_MCYC)
        assert snap["crossings"][M.VM_EXIT] == n * F.VSOCK_EXITS_PER_MSG
        assert snap["crossings"][M.CTRL_MSG] == n

    def test_charges_equal_reference(self):
        from repro.core import metrics as ref_M
        books = []
        for P, Mod in ((planes, M), (ref_planes, ref_M)):
            acct = Mod.CycleAccount()
            plane = P.ControlPlane(acct)
            for i in range(5):
                plane.send(P.ControlMessage("complete", "t", body={"i": i}))
            books.append(acct.snapshot())
        assert books[0] == books[1]

    def test_oversize_message_rejected_without_side_effects(self):
        """Bulk payloads must ride the data plane: an oversized
        descriptor raises, charges nothing, enqueues nothing."""
        plane, acct = _plane()
        big = ControlMessage("put", "t",
                             body={"blob": "x" * (CTRL_MSG_MAX_BYTES + 1)})
        with pytest.raises(ValueError, match="data plane"):
            plane.send(big)
        assert plane.sent == 0
        assert acct.total() == 0.0
        assert plane.try_recv() is None

    def test_boundary_size_is_accepted(self):
        plane, _ = _plane()
        pad = CTRL_MSG_MAX_BYTES - 64 - len("k")
        msg = ControlMessage("put", "t", body={"k": "y" * pad})
        assert msg.approx_size() == CTRL_MSG_MAX_BYTES
        plane.send(msg)
        assert plane.recv(timeout=1.0) is msg

    def test_try_recv_empty_returns_none(self):
        plane, _ = _plane()
        assert plane.try_recv() is None
        msg = ControlMessage("invoke", "t")
        plane.send(msg)
        assert plane.try_recv() is msg
        assert plane.try_recv() is None

    def test_bounded_depth_backpressure(self):
        """The channel is a BOUNDED queue — the host can push back on a
        flooding guest instead of buffering unboundedly."""
        plane, _ = _plane(depth=2)
        plane.send(ControlMessage("invoke", "t"))
        plane.send(ControlMessage("invoke", "t"))
        with pytest.raises(queue.Full):
            plane._q.put_nowait(ControlMessage("invoke", "t"))


class TestCallReply:
    def test_call_blocks_until_host_replies(self):
        plane, _ = _plane()
        served = []

        def host():
            msg = plane.recv(timeout=5.0)
            served.append(msg)
            reply(msg, {"status": "ok", "echo": msg.body["x"]})

        t = threading.Thread(target=host)
        t.start()
        out = call(plane, ControlMessage("get", "t", body={"x": 42}),
                   timeout=5.0)
        t.join(timeout=5.0)
        assert out == {"status": "ok", "echo": 42}
        assert served[0].body == {"x": 42}

    def test_reply_to_non_call_asserts(self):
        msg = ControlMessage("invoke", "t")
        with pytest.raises(AssertionError, match="not a call"):
            reply(msg, "value")

    def test_call_timeout_when_host_silent(self):
        plane, _ = _plane()
        with pytest.raises(queue.Empty):
            call(plane, ControlMessage("get", "t"), timeout=0.05)


# -------------------------------------------------------------- trace

FUNCTIONS = [f"{name}#{i}" for i, name in enumerate(
    ["ST-R", "IMG", "ML-INF", "ETL", "VID", "ST-R", "KV"])]


@pytest.mark.parametrize("seed", [0, 1, 7, 2790])
@pytest.mark.parametrize("sigma", [0.6, 1.0])
def test_sample_rates_equal_reference(seed, sigma):
    port = trace.sample_rates(FUNCTIONS, seed, mean_rate=1.6, sigma=sigma)
    ref = ref_trace.sample_rates(FUNCTIONS, seed, mean_rate=1.6,
                                 sigma=sigma)
    assert [dataclasses.astuple(s) for s in port] == [
        dataclasses.astuple(s) for s in ref]


@pytest.mark.parametrize("seed", [0, 3, 13, 2790])
@pytest.mark.parametrize("pattern", [None, *ref_W.ARRIVAL_PATTERNS])
def test_arrival_streams_equal_reference(pattern, seed):
    """Every function's stream, float for float, under no pattern (the
    default MMPP) and under each named `ArrivalPattern`; then the merged
    feed, the offered load and each stream's inter-arrival CV."""
    kw = {} if pattern is None else {"pattern": W.ARRIVAL_PATTERNS[pattern]}
    rkw = {} if pattern is None else {"pattern":
                                      ref_W.ARRIVAL_PATTERNS[pattern]}
    port, ref = {}, {}
    for s, r in zip(trace.sample_rates(FUNCTIONS, seed, mean_rate=2.0),
                    ref_trace.sample_rates(FUNCTIONS, seed, mean_rate=2.0)):
        port[s.function] = trace.generate_arrivals(s, 120.0, seed, **kw)
        ref[r.function] = ref_trace.generate_arrivals(r, 120.0, seed, **rkw)
    assert port == ref
    assert sum(map(len, port.values())) > 0
    assert trace.merge_streams(port) == ref_trace.merge_streams(ref)
    assert trace.offered_load(port, 120.0) == ref_trace.offered_load(
        ref, 120.0)
    cvs = [trace.interarrival_cv(v) for v in port.values()]
    ref_cvs = [ref_trace.interarrival_cv(v) for v in ref.values()]
    assert [repr(c) for c in cvs] == [repr(c) for c in ref_cvs]


def test_mmpp_knobs_and_degenerate_streams_equal_reference():
    spec = trace.ArrivalSpec("f#1", 3.0)
    rspec = ref_trace.ArrivalSpec("f#1", 3.0)
    for kw in ({"burst_factor": 5.0}, {"burst_fraction": 0.5},
               {"burst_factor": 1.5, "burst_fraction": 0.1}):
        assert trace.generate_arrivals(spec, 200.0, 4, **kw) == \
            ref_trace.generate_arrivals(rspec, 200.0, 4, **kw)
    zero = trace.ArrivalSpec("f#2", 0.0)
    assert trace.generate_arrivals(zero, 100.0, 1) == []
    assert trace.offered_load({"a": [1.0]}, 0.0) == 0.0
    assert trace.merge_streams({}) == ref_trace.merge_streams({}) == []


# -------------------------------------------------------------- fluid

@pytest.mark.parametrize("system", ALL_SYSTEMS)
def test_fluid_first_fail_equals_reference(system):
    """On the paper suite at `find_density`'s grid and at a tight
    cluster whose boundary falls inside the grid."""
    for kw in (dict(lo=40, hi=2000, step=40, seed=1),
               dict(lo=4, hi=120, step=24, seed=2, nodes=1, cores=4,
                    mem_gb=4.0, max_vms_per_node=64, mean_rate=2.5),
               dict(lo=20, hi=800, step=20, seed=7,
                    arrival_pattern="poisson")):
        assert fluid.fluid_first_fail(system, **kw) == \
            ref_fluid.fluid_first_fail(system, **kw), kw


@pytest.mark.parametrize("system", ALL_SYSTEMS)
def test_fluid_passes_equals_reference(system):
    got = [fluid.fluid_passes(system, n, seed=3) for n in range(40, 2001,
                                                                 160)]
    want = [ref_fluid.fluid_passes(system, n, seed=3)
            for n in range(40, 2001, 160)]
    assert got == want
    assert got[0] and not got[-1]
    assert fluid._workload_stats(system, W.SUITE) == \
        ref_fluid._workload_stats(system, ref_W.SUITE)


def test_fluid_constants_equal_reference():
    assert fluid._TAIL == ref_fluid._TAIL
    assert fluid._TAIL_DEFAULT == ref_fluid._TAIL_DEFAULT
    assert fluid._MEM_CRIT == ref_fluid._MEM_CRIT


# ------------------------------------------------------------- scaled

def _policies(G):
    return (
        G.GuardrailPolicy(),
        G.GuardrailPolicy(
            admission=G.AdmissionSpec(rate_per_s=2.0, burst=3.0,
                                      max_queue_s=1.0),
            deadline_factor=6.0),
        G.GuardrailPolicy(retry=G.RetrySpec(),
                          breaker=G.BreakerSpec(open_s=0.5),
                          drains=(G.DrainWindow(2.0, 1.0),
                                  G.DrainWindow(7.5, 0.25))),
        G.GuardrailPolicy(
            admission=G.AdmissionSpec(rate_per_s=40.0, burst=8.0),
            retry=G.RetrySpec(backoff_base_s=0.02, max_backoff_s=0.4),
            breaker=G.BreakerSpec(window_s=3.0, open_s=1.5),
            deadline_factor=3.0),
    )


@pytest.mark.parametrize("time_scale", [0.5, 1.0, 4.0, 37.5])
@pytest.mark.parametrize("which", range(4))
def test_scaled_equals_reference_field_for_field(which, time_scale):
    port = _policies(GR)[which]
    ref = _policies(ref_GR)[which]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    got = port.scaled(time_scale)
    want = ref.scaled(time_scale)
    assert type(got) is GR.GuardrailPolicy
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if time_scale == 1.0:
        assert got == port
