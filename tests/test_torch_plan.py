"""The port's PhasePlan compiler, workload profiles and cost model
against the reference's (`repro.core.plan`, `repro.core.workloads`).

The arithmetic is copied, so the comparisons are exact: the compiled
programs structurally, `phase_durations` and `unloaded_latency` to the
bit, for every system variant x MLServe scenario x cold/warm, at both
calibrated scales.
"""
import dataclasses

import pytest

from repro.core import plan as ref_plan
from repro.core import workloads as ref_workloads
from repro_torch.core import plan, workloads
from repro_torch.core.transport import TRANSPORTS

SYSTEMS = list(ref_plan.SYSTEMS)
SCENARIOS = list(ref_workloads.ML_SCENARIO_NAMES)
SCALES = ("tiny", "full")

#: PlanProgram's lowered arrays (every field but the plan it came from)
PROGRAM_FIELDS = [f.name for f in dataclasses.fields(plan.PlanProgram)
                  if f.name != "plan"]


def _suites(scale):
    return workloads.ml_suite(scale), ref_workloads.ml_suite(scale)


def _profile_ops(profile):
    return [(type(op).__name__, dataclasses.asdict(op)) for op in profile.ops]


def _phases(p):
    return [(ph.name, ph.resource, ph.after, ph.backend_group)
            for ph in p.phases]


def test_systems_equal_reference_field_by_field():
    assert list(plan.SYSTEMS) == SYSTEMS
    for name, spec in plan.SYSTEMS.items():
        ref = ref_plan.SYSTEMS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref), name
        for prop in ("coupled", "memory_variant"):
            assert getattr(spec, prop) == getattr(ref, prop), (name, prop)


def test_plan_constants_equal_reference():
    for name in ("MB", "GUEST_CORE", "BACKEND_WORKER", "WIRE", "NONE",
                 "RESOURCES", "_GROUP_BASE"):
        assert getattr(plan, name) == getattr(ref_plan, name), name
    assert (_profile_ops(plan.DEFAULT_PROFILE)
            == _profile_ops(ref_plan.DEFAULT_PROFILE))


@pytest.mark.parametrize("scale", SCALES)
def test_ml_suite_profiles_equal_reference(scale):
    """The same scenarios, sizes, compute budgets and resident libs."""
    port, ref = _suites(scale)
    assert list(port) == list(ref) == SCENARIOS
    for name in SCENARIOS:
        assert _profile_ops(port[name].profile) == _profile_ops(
            ref[name].profile), name
        for attr in ("name", "extra_libs_mb", "deterministic_input",
                     "input_bytes", "output_bytes", "compute_mcycles"):
            assert getattr(port[name], attr) == getattr(ref[name], attr), (
                name, attr)
        assert port[name].profile.shape == ref[name].profile.shape
        assert port[name].profile.io_kinds == ref[name].profile.io_kinds


def test_ml_suite_constants_and_handlers():
    assert workloads.ML_SCENARIO_NAMES == ref_workloads.ML_SCENARIO_NAMES
    assert workloads._ML_LIBS == ref_workloads._ML_LIBS
    assert workloads.MB == ref_workloads.MB
    tiny, full = workloads.ml_suite("tiny"), workloads.ml_suite("full")
    for name in SCENARIOS:
        # one handler code object across scales, as the reference's
        assert tiny[name].handler is full[name].handler
    with pytest.raises(ValueError, match="unknown ml_suite scale"):
        workloads.ml_suite("medium")
    # the MLServe suite stays out of the deployable set, as in the
    # reference, which deploys the paper suite and the scenarios by name
    assert list(workloads.REGISTRY) == list(ref_workloads.REGISTRY)
    assert not set(SCENARIOS) & set(workloads.REGISTRY)


def test_profile_effective_and_shape_follow_reference():
    """`effective` downgrades a GET whose hint is missing or opaque, and
    `shape` keeps only the first GET's prefetch flag, in both."""
    from repro.core.hints import extract_hints, make_event
    prof = workloads.ml_suite("tiny")["LLM-COLD"].profile
    rprof = ref_workloads.ml_suite("tiny")["LLM-COLD"].profile
    n = len(prof.gets)
    for sizes in ([10] * n, [None] + [10] * (n - 1), [10] * (n - 1)):
        event = make_event([("in", f"k{i}", s) for i, s in enumerate(sizes)],
                           [("out", "o")])
        hints = extract_hints(event)[0]
        assert (_profile_ops(prof.effective(hints))
                == _profile_ops(rprof.effective(hints)))
        assert prof.effective(hints).shape == rprof.effective(hints).shape


@pytest.mark.parametrize("cold", [True, False], ids=["cold", "warm"])
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_compiled_program_equals_reference(system, scenario, cold):
    """Phases, dependencies, resources, backend groups, breakdown groups
    and the release and response barriers, and every lowered array."""
    spec, rspec = plan.SYSTEMS[system], ref_plan.SYSTEMS[system]
    port, ref = _suites("tiny")
    bypass = TRANSPORTS[spec.transport].kernel_bypass
    prog = plan.compile_program(spec, port[scenario].profile, cold=cold,
                                kernel_bypass=bypass)
    rprog = ref_plan.compile_program(rspec, ref[scenario].profile,
                                     cold=cold, kernel_bypass=bypass)
    p, rp = prog.plan, rprog.plan
    assert (p.system, p.cold) == (rp.system, rp.cold)
    assert _phases(p) == _phases(rp)
    assert (p.release_after, p.respond_after) == (rp.release_after,
                                                  rp.respond_after)
    assert (p.release_group, p.respond_group) == (rp.release_group,
                                                  rp.respond_group)
    assert p.groups() == rp.groups()
    assert p.group_deps() == rp.group_deps()
    assert p.backend_groups() == rp.backend_groups()
    for name in p.phase_names:
        assert p.ancestors(name) == rp.ancestors(name), name
    for field in PROGRAM_FIELDS:
        assert getattr(prog, field) == getattr(rprog, field), field
    # the full-scale profile has the same shape, so the same program
    full = workloads.ml_suite("full")[scenario].profile
    assert plan.compile_program(spec, full, cold=cold,
                                kernel_bypass=bypass) is prog


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_phase_durations_and_unloaded_latency_equal_reference(
        system, scenario, scale):
    spec, rspec = plan.SYSTEMS[system], ref_plan.SYSTEMS[system]
    port, ref = _suites(scale)
    w, rw = port[scenario], ref[scenario]
    for cold in (True, False):
        assert (plan.phase_durations(spec, w, cold)
                == ref_plan.phase_durations(rspec, rw, cold)), cold
        assert (plan.duration_vector(spec, w, cold)
                == ref_plan.duration_vector(rspec, rw, cold)), cold
        durs = plan.phase_durations(spec, w, cold)
        assert (plan.compile_plan(spec, w.profile, cold).critical_path(durs)
                == ref_plan.compile_plan(rspec, rw.profile,
                                         cold).critical_path(durs))
    assert (plan.unloaded_latency(spec, w)
            == ref_plan.unloaded_latency(rspec, rw))


def test_cache_vector_equals_reference():
    prog = plan.compile_program(plan.SYSTEMS["nexus"],
                                workloads.ml_suite("tiny")["LLM-COLD"].profile)
    assert plan.cache_vector(prog.names) == ref_plan.cache_vector(prog.names)


def test_incoherent_spec_rejected_like_reference():
    bad = dataclasses.replace(plan.SYSTEMS["baseline"], name="bad",
                              prefetch=True)
    with pytest.raises(ValueError, match="require offload_sdk"):
        plan.compile_plan(bad)


def test_verify_on_compile_names_the_missing_verifier():
    """The switch is kept and off by default; turned on, compiling a new
    program runs PlanVerify (`analysis.verify.verify_program`, copied
    since it was missing), which passes a sound program and rejects a
    damaged one with its code."""
    from repro_torch.core.analysis import verify
    from repro_torch.core.analysis.diag import PlanCheckError
    assert plan.verify_on_compile() is False
    prev = plan.set_verify_on_compile(True)
    seen = []
    real = verify.verify_program
    try:
        verify.verify_program = lambda prog: (seen.append(prog),
                                              real(prog))[1]
        prog = plan.compile_program(plan.SYSTEMS["nexus"], cold=True)
        assert seen == [prog]
        bad = dataclasses.replace(prog, roots=())
        with pytest.raises(PlanCheckError) as e:
            real(bad)
        assert e.value.code == "V-ROOTS"
    finally:
        verify.verify_program = real
        plan.set_verify_on_compile(prev)
        plan._compile_program.cache_clear()
    assert plan.verify_on_compile() is False
