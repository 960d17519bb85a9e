"""The port's FaultPlane (`repro_torch.core.faults`) against the
reference's (`repro.core.faults`), on the CPU.

What is held:

* `FaultSpec` / `FaultSchedule`: the seeded generator gives the
  reference's schedule field for field for a fixed list of seeds and
  rates, with the same windows, crash instants, horizon and stretched
  (`scaled`) copy; the same bad specs raise in both;
* `GuardrailPolicy.drains_for` gives the reference's drain windows;
* `FaultInjector` arms a port node through the same seams as the
  reference's arms a reference node (storage windows, hooks, restart
  delay), and disarms it;
* the crash-only contract on the port's node: one hand-built schedule
  per fault kind, plus a crash-heavy mix, replayed against the chaos
  suite under each of the 7 variants while the caller re-drives failed
  invocations under the same invocation id: every caller gets exactly
  one response, and the durable outputs are byte-identical to the
  port's fault-free oracle.

The reference's hypothesis-drawn threaded matrix is not repeated here;
its seed 2790, which exposes the reference's known `BackendCrashed`
defect (a bare re-drive loop spends its attempts inside one restart
window), is replayed as one case.
"""
import dataclasses
import time

import pytest

from repro.core import faults as ref_faults
from repro.core import guardrails as ref_guardrails
from repro.core import runtime as ref_runtime
from repro_torch.core import faults, guardrails, runtime, workloads
from repro_torch.core.backend import BackendCrashed
from repro_torch.core.faults import (ACK_DROP, ARENA_EXHAUST, BACKEND_CRASH,
                                     RESTORE_FAIL, STORAGE_ERROR,
                                     STORAGE_SLOW, FaultInjector,
                                     FaultSchedule, FaultSpec)

ALL_SYSTEMS = ("baseline", "nexus-tcp", "nexus-async", "nexus",
               "nexus-sdk-only", "nexus-prefetch-only", "wasm")


def _chaos_kw(horizon_s, intensity):
    """The reference chaos harness's rates (`tests/chaos.py`)."""
    per_s = intensity / horizon_s
    return dict(crash_rate=1.5 * per_s, storage_slow_rate=0.7 * per_s,
                storage_error_rate=0.5 * per_s, ack_drop_rate=0.7 * per_s,
                restore_fail_rate=0.5 * per_s,
                arena_exhaust_rate=0.3 * per_s,
                mean_window_s=horizon_s * 0.08, slow_factor=6.0)


def _schedule_from_seed(F, seed, horizon_s, *, intensity=1.0,
                        restart_delay_s=None):
    kw = {} if restart_delay_s is None else {"restart_delay_s":
                                             restart_delay_s}
    return F.FaultSchedule.generate(seed, horizon_s * 0.8,
                                    **_chaos_kw(horizon_s, intensity), **kw)


def _fields(schedule):
    return dataclasses.asdict(schedule)


# ------------------------------------------------------------- pure data

@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2790, 9999])
@pytest.mark.parametrize("horizon_s,intensity", [(1.0, 1.5), (10.0, 0.5),
                                                 (10.0, 2.0)])
def test_generate_equals_reference(seed, horizon_s, intensity):
    port = _schedule_from_seed(faults, seed, horizon_s, intensity=intensity)
    ref = _schedule_from_seed(ref_faults, seed, horizon_s,
                              intensity=intensity)
    assert _fields(port) == _fields(ref)
    for kind in faults.KINDS:
        assert port.windows(kind) == ref.windows(kind)
    assert port.crashes() == ref.crashes()
    assert port.horizon() == ref.horizon()
    assert port.is_empty == ref.is_empty
    assert _fields(port.scaled(2.5)) == _fields(ref.scaled(2.5))
    for t in (0.0, 0.1, 0.37, horizon_s * 0.5):
        for kind in faults.KINDS:
            assert port.window_at(kind, t) == ref.window_at(kind, t)


def test_single_kind_generators_equal_reference():
    for rate_kw in ("crash_rate", "storage_slow_rate", "storage_error_rate",
                    "ack_drop_rate", "restore_fail_rate",
                    "arena_exhaust_rate"):
        port = faults.FaultSchedule.generate(5, 20.0, **{rate_kw: 0.8},
                                             restart_delay_s=0.3)
        ref = ref_faults.FaultSchedule.generate(5, 20.0, **{rate_kw: 0.8},
                                                restart_delay_s=0.3)
        assert _fields(port) == _fields(ref), rate_kw
        assert not port.is_empty


@pytest.mark.parametrize("bad", [
    dict(kind="meteor", at_s=0.0),
    dict(kind=BACKEND_CRASH, at_s=-1.0),
    dict(kind=STORAGE_SLOW, at_s=0.0, duration_s=-1.0),
    dict(kind=STORAGE_SLOW, at_s=0.0, duration_s=1.0, factor=1.0),
    dict(kind=ACK_DROP, at_s=0.0),
], ids=["kind", "negative at", "negative window", "slow factor",
        "window missing"])
def test_bad_specs_raise_like_reference(bad):
    for F in (faults, ref_faults):
        with pytest.raises(ValueError):
            F.FaultSpec(**bad)


def test_bad_schedules_raise_like_reference():
    for F in (faults, ref_faults):
        with pytest.raises(ValueError):
            F.FaultSchedule((), restart_delay_s=0.0)
        with pytest.raises(TypeError):
            F.FaultSchedule(("not a spec",))


def test_schedule_sorts_and_queries_like_reference():
    def build(F):
        return F.FaultSchedule((
            F.FaultSpec(F.STORAGE_SLOW, 2.0, 1.0, 4.0),
            F.FaultSpec(F.BACKEND_CRASH, 1.0),
            F.FaultSpec(F.ACK_DROP, 0.5, 0.25)), restart_delay_s=0.3)
    port, ref = build(faults), build(ref_faults)
    assert _fields(port) == _fields(ref)
    assert [s.kind for s in port.specs] == [ACK_DROP, BACKEND_CRASH,
                                            STORAGE_SLOW]
    assert port.window_at(STORAGE_SLOW, 2.5) == (2.0, 3.0, 4.0)
    assert port.window_at(STORAGE_SLOW, 3.0) is None
    assert port.horizon() == ref.horizon() == 3.0
    assert FaultSchedule.empty().is_empty


@pytest.mark.parametrize("seed", [0, 3, 2790])
def test_drains_for_equals_reference(seed):
    sched = _schedule_from_seed(faults, seed, 10.0, intensity=2.0)
    rsched = _schedule_from_seed(ref_faults, seed, 10.0, intensity=2.0)
    for kw in ({}, {"lead_s": 0.1, "settle_s": 0.5}):
        got = guardrails.GuardrailPolicy.drains_for(sched, **kw)
        want = ref_guardrails.GuardrailPolicy.drains_for(rsched, **kw)
        assert [dataclasses.asdict(d) for d in got] == [
            dataclasses.asdict(d) for d in want]
        assert len(got) == len(sched.crashes())


# --------------------------------------------------------- the injector

def _armed_state(node):
    plan = node.remote.faults
    hooks = node.fault_hooks
    return (plan.slow_windows, plan.fail_windows,
            hooks.ack_drop is not None, hooks.restore_fail is not None,
            hooks.guest_crash is not None,
            None if node.supervisor is None
            else node.supervisor.restart_delay_s)


@pytest.mark.parametrize("system", ["nexus", "baseline"])
def test_injector_arms_and_disarms_like_reference(system):
    def build(F):
        return F.FaultSchedule((
            F.FaultSpec(F.STORAGE_SLOW, 5.0, 1.0, 4.0),
            F.FaultSpec(F.STORAGE_ERROR, 7.0, 1.0),
            F.FaultSpec(F.BACKEND_CRASH, 60.0)), restart_delay_s=0.3)
    states = []
    for R, F, kw in ((runtime, faults, {"device": "cpu"}),
                     (ref_runtime, ref_faults, {})):
        node = R.WorkerNode(system, **kw)
        try:
            idle = _armed_state(node)
            inj = F.FaultInjector(node, build(F)).start()
            armed = _armed_state(node)
            inj.stop()
            states.append((idle, armed, _armed_state(node), inj.stats))
        finally:
            node.shutdown()
    assert states[0] == states[1]
    idle, armed, after, stats = states[0]
    assert armed[0] == ((5.0, 6.0, 4.0),) and armed[1] == ((7.0, 8.0, 8.0),)
    assert after[2:5] == (False, False, False)
    assert stats == {"crashes": 0, "acks_dropped": 0, "restores_failed": 0,
                     "arena_hogs": 0}


def run_threaded(system, schedule, *, n_invocations=4, spacing_s=0.1,
                 max_attempts=8, ack_timeout_s=0.5, redrive_backoff_s=0.0,
                 cache=None):
    """The reference chaos harness's `run_threaded` on the port's node:
    drive the chaos suite while the schedule plays, re-driving failures
    under the same invocation id until each caller holds exactly one
    successful response."""
    node = runtime.WorkerNode(system, writeback_ack_timeout_s=ack_timeout_s,
                              plan_stall_timeout_s=30.0, cache=cache,
                              device="cpu")
    suite = workloads.chaos_suite()
    try:
        for w in suite.values():
            node.deploy(w)
            node.seed_input(w.name)
        names = list(suite)
        injector = None
        if schedule is not None and not schedule.is_empty:
            injector = FaultInjector(node, schedule).start()
        try:
            pending = []
            for i in range(n_invocations):
                fn, inv_id = names[i % len(names)], f"chaos-{i}"
                pending.append((fn, inv_id, node.invoke(fn, inv_id=inv_id)))
                time.sleep(spacing_s)
            responses, attempts = {}, {}
            for fn, inv_id, fut in pending:
                attempts[inv_id] = 1
                while True:
                    try:
                        res = fut.result(timeout=60)
                        assert all(e is not None for e in res.output_etags)
                        responses[inv_id] = responses.get(inv_id, 0) + 1
                        break
                    except AssertionError:
                        raise
                    except Exception:
                        if attempts[inv_id] >= max_attempts:
                            raise
                        attempts[inv_id] += 1
                        if redrive_backoff_s:
                            time.sleep(redrive_backoff_s)
                        fut = node.invoke(fn, inv_id=inv_id)
        finally:
            if injector is not None:
                injector.stop()
        stats = dict(injector.stats) if injector is not None else {}
        return node.store.list_bucket("out"), responses, attempts, stats
    finally:
        node.shutdown()


def check_invariants(oracle, faulted, label):
    durable, responses, _, _ = faulted
    assert durable.keys() == oracle[0].keys(), label
    diff = [k for k in oracle[0] if durable[k] != oracle[0][k]]
    assert not diff, f"{label}: durable bytes diverged for {diff}"
    assert all(v == 1 for v in responses.values()), (label, responses)
    assert responses.keys() == oracle[1].keys(), label


_ORACLES = {}


def _oracle(system):
    if system not in _ORACLES:
        _ORACLES[system] = run_threaded(system, None)
    return _ORACLES[system]


#: one hand-built schedule per fault kind, inside the ~0.4 s the four
#: invocations take, plus a crash-heavy mix
SCHEDULES = {
    BACKEND_CRASH: (FaultSpec(BACKEND_CRASH, 0.05),),
    STORAGE_SLOW: (FaultSpec(STORAGE_SLOW, 0.0, 0.3, 6.0),),
    STORAGE_ERROR: (FaultSpec(STORAGE_ERROR, 0.05, 0.1),),
    ACK_DROP: (FaultSpec(ACK_DROP, 0.0, 0.4),),
    RESTORE_FAIL: (FaultSpec(RESTORE_FAIL, 0.0, 0.2),),
    ARENA_EXHAUST: (FaultSpec(ARENA_EXHAUST, 0.05, 0.2),),
    "crash-heavy mix": (FaultSpec(BACKEND_CRASH, 0.03),
                        FaultSpec(BACKEND_CRASH, 0.12),
                        FaultSpec(BACKEND_CRASH, 0.25),
                        FaultSpec(BACKEND_CRASH, 0.4),
                        FaultSpec(STORAGE_SLOW, 0.1, 0.2, 6.0),
                        FaultSpec(STORAGE_ERROR, 0.3, 0.05),
                        FaultSpec(ACK_DROP, 0.2, 0.2)),
}


@pytest.mark.parametrize("system", ALL_SYSTEMS)
@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_injector_keeps_durable_state_byte_identical(kind, system):
    schedule = FaultSchedule(SCHEDULES[kind], restart_delay_s=0.02)
    faulted = run_threaded(system, schedule, max_attempts=20,
                           redrive_backoff_s=0.04)
    check_invariants(_oracle(system), faulted, f"{system}/{kind}")
    stats = faulted[3]
    offloaded = not runtime.SYSTEMS[system].coupled
    if kind in (BACKEND_CRASH, "crash-heavy mix") and offloaded:
        assert stats["crashes"] == len(schedule.crashes())
    if kind == ARENA_EXHAUST and offloaded:
        assert stats["arena_hogs"] >= 1


def _ran_out_on_crash(exc, crashed):
    """Whether the exception the re-drives ran out on is, or was caused
    by, the backend being down (`crashed`, a package's
    `BackendCrashed`)."""
    while exc is not None:
        if isinstance(exc, crashed):
            return True
        exc = exc.__cause__
    return False


#: the most replays of the reference's seed-2790 schedule the case runs
#: to see the reference's defect: a replay races the same wall clock as
#: the port's, and under a loaded host (six test workers) about half of
#: the replays of all 7 variants pass every one
REF_REPLAYS = 16


def _reference_2790_failure(schedule, replays=REF_REPLAYS):
    """The first variant whose reference replay of seed 2790 (the
    reference harness, `tests/chaos.py::run_threaded`, at its defaults)
    runs out of re-drives on `BackendCrashed`, over up to `replays`
    replays of the 7 variants, and the replay it failed in; (None,
    replays) if none does. Any other failure is raised."""
    from repro.core.backend import BackendCrashed as RefCrashed
    from tests.chaos import run_threaded as ref_run_threaded
    for replay in range(1, replays + 1):
        for system in ALL_SYSTEMS:
            try:
                ref_run_threaded(system, schedule)
            except Exception as e:      # noqa: BLE001 — sorted below
                if not _ran_out_on_crash(e, RefCrashed):
                    raise
                return system, replay
    return None, replays


def test_seed_2790_replay():
    """The reference's hypothesis seed 2790 at its harness's settings
    (six invocations 0.12 s apart, eight bare re-drives).

    The reference's defect: a crash that lands just before an
    invocation makes all eight bare re-drives fail inside one restart
    window. Which variants it reaches depends on thread timing, in the
    reference's own replay too (one variant has passed and failed in
    two replays in one process), so the case holds the kind of failure
    and not the set: every port failure must be the re-drives running
    out on `BackendCrashed`, anything else fails the test, and the
    reference's replay of the same schedule, run here, must show the
    defect too. Only then is the case an expected failure. The
    reference's replay races the wall clock as the port's does, so it
    is replayed up to `REF_REPLAYS` times and the first variant that
    shows the defect is taken: one passing replay does not show that
    the schedule cannot expose it."""
    schedule = _schedule_from_seed(faults, 2790, 1.0, intensity=1.5,
                                   restart_delay_s=0.02)
    failed = []
    for system in ALL_SYSTEMS:
        oracle = run_threaded(system, None, n_invocations=6, spacing_s=0.12)
        try:
            faulted = run_threaded(system, schedule, n_invocations=6,
                                   spacing_s=0.12)
        except Exception as e:          # noqa: BLE001 — sorted below
            if not _ran_out_on_crash(e, BackendCrashed):
                raise
            failed.append(system)
            continue
        check_invariants(oracle, faulted, f"{system}/2790")
    if not failed:
        return
    ref_failed, replay = _reference_2790_failure(
        _schedule_from_seed(ref_faults, 2790, 1.0, intensity=1.5,
                            restart_delay_s=0.02))
    assert ref_failed, ("the port runs out of re-drives on BackendCrashed "
                        f"where {replay} replays of the reference pass "
                        f"every variant: {failed}")
    pytest.xfail("the reference's known BackendCrashed defect, mirrored "
                 f"(ROADMAP Queue 3): port {failed}, reference "
                 f"{ref_failed} in replay {replay}")
