"""The port's PlanVerify (`repro_torch.core.analysis.verify`) against the
reference's (`repro.core.analysis.verify`), on the CPU.

What is held:

* every `SYSTEMS` variant x every profile the port deploys (the paper
  suite, the scenarios, the chaos suite and the MLServe suite at both
  scales) x cold/warm x both transport lowerings compiles to a program
  that both packages' `verify_program` (with the duration vector) and
  `verify_plan` pass;
* the reference's seeded corruptions (`repro.core.analysis.mutate`, the
  damage classes `tests/test_plancheck.py` pins), applied to the
  reference's programs and carried over to the port's types, raise in
  the port the diagnostic code they raise in the reference, on every
  eligible cell; and the port's own corruptor
  (`repro_torch.core.analysis.mutate`) on the port's own programs
  raises the same codes in the port's verifier;
* `NEXUS_VERIFY_PLANS` on (`plan.set_verify_on_compile`) makes the
  port's compiler verify each new program instead of raising;
* the SharedCache overlay checker, fed the reference DES's overlays
  (`repro.core.des.cache_overlay`) carried over to the port's types,
  passes them and rejects the reference's three corruptions with the
  same codes; its two opcode constants are pinned to the DES's;
* the same checker fed the overlays the port's own DES builds
  (`repro_torch.core.des._build_bundle` and `cache_overlay`) for every
  variant x profile x cold/warm: they equal the reference DES's, pass,
  and the three corruptions raise the same codes; the checker reads its
  opcodes from the port's DES and keeps no copy of them.
"""
import dataclasses

import pytest

from repro.core import des as ref_des
from repro.core import plan as ref_plan
from repro.core import workloads as ref_workloads
from repro.core.analysis import diag as ref_diag
from repro.core.analysis import mutate as ref_mutate
from repro.core.analysis import verify as ref_verify
from repro.core.transport import TRANSPORTS
from repro_torch.core import des, plan, workloads
from repro_torch.core.transport import TRANSPORTS as PORT_TRANSPORTS
from repro_torch.core.analysis import diag, mutate, verify
from repro_torch.core.analysis.diag import PlanCheckError

SYSTEMS = list(ref_plan.SYSTEMS)


def _profiles(W):
    return {**{n: w for n, w in W.REGISTRY.items()},
            **W.chaos_suite(),
            **{f"{n} tiny": w for n, w in W.ml_suite("tiny").items()},
            **{f"{n} full": w for n, w in W.ml_suite("full").items()}}


def _to_port(prog):
    """A reference `PlanProgram` (and its `PhasePlan`) as the port's
    types, field for field."""
    rp = prog.plan
    pplan = plan.PhasePlan(
        rp.system, rp.cold,
        tuple(plan.Phase(p.name, p.resource, p.after, p.backend_group)
              for p in rp.phases),
        rp.release_after, rp.respond_after)
    kw = {f.name: getattr(prog, f.name)
          for f in dataclasses.fields(prog) if f.init}
    kw["plan"] = pplan
    return plan.PlanProgram(**kw)


def _fields(prog):
    return {f.name: getattr(prog, f.name)
            for f in dataclasses.fields(prog) if f.init and f.name != "plan"}


@pytest.mark.parametrize("system", SYSTEMS)
def test_clean_programs_verify_in_both_packages(system):
    spec, rspec = plan.SYSTEMS[system], ref_plan.SYSTEMS[system]
    port, ref = _profiles(workloads), _profiles(ref_workloads)
    for name in port:
        for cold in (True, False):
            for kb in (False, True):
                prog = plan.compile_program(spec, port[name].profile, cold,
                                            kernel_bypass=kb)
                rprog = ref_plan.compile_program(rspec, ref[name].profile,
                                                 cold, kernel_bypass=kb)
                durs = plan.duration_vector(spec, port[name], cold)
                assert durs == ref_plan.duration_vector(rspec, ref[name],
                                                        cold)
                verify.verify_program(prog, durations=durs)
                verify.verify_plan(prog.plan)
                ref_verify.verify_program(rprog, durations=durs)
                assert _fields(prog) == _fields(rprog), (name, cold, kb)
                # the reference's program carried over verifies too
                verify.verify_program(_to_port(rprog), durations=durs)


_MUTATION_CELLS = [
    ("nexus", "PIPE", True), ("nexus", "PIPE", False),
    ("nexus", "SG", True), ("nexus", "FAN", True),
    ("nexus-tcp", "PIPE", True), ("nexus-async", "PIPE", True),
    ("baseline", "PIPE", True), ("baseline", "AES", False),
]


def _ref_cell(system, wname, cold):
    spec = ref_plan.SYSTEMS[system]
    w = ref_workloads.REGISTRY[wname]
    kb = TRANSPORTS[spec.transport].kernel_bypass
    prog = ref_plan.compile_program(spec, w.profile, cold, kernel_bypass=kb)
    return prog, ref_plan.duration_vector(spec, w, cold)


@pytest.mark.parametrize("c", ref_mutate.CORRUPTIONS, ids=lambda c: c.name)
def test_corruption_caught_with_the_reference_code(c):
    caught = 0
    for system, wname, cold in _MUTATION_CELLS:
        prog, durs = _ref_cell(system, wname, cold)
        try:
            bad, bad_durs = ref_mutate.corrupt(prog, durs, c.name, seed=7)
        except ref_mutate.Ineligible:
            continue
        with pytest.raises(ref_diag.PlanCheckError) as ref_err:
            ref_verify.verify_program(bad, durations=bad_durs)
        with pytest.raises(PlanCheckError) as err:
            verify.verify_program(_to_port(bad), durations=bad_durs,
                                  subject=f"{system}/{wname}")
        assert err.value.code == ref_err.value.code == c.code, (
            c.name, system, wname, cold)
        caught += 1
    assert caught, f"no eligible cell for corruption {c.name}"


@pytest.mark.parametrize("c", mutate.CORRUPTIONS, ids=lambda c: c.name)
def test_corruption_caught_with_the_port_mutate(c):
    """The twin of the test above with the port's own corruptor applied
    to the port's own program: the same code as the reference's
    corruptor and verifier give on the reference's program."""
    caught = 0
    for system, wname, cold in _MUTATION_CELLS:
        rprog, rdurs = _ref_cell(system, wname, cold)
        spec = plan.SYSTEMS[system]
        w = workloads.REGISTRY[wname]
        kb = PORT_TRANSPORTS[spec.transport].kernel_bypass
        prog = plan.compile_program(spec, w.profile, cold, kernel_bypass=kb)
        durs = plan.duration_vector(spec, w, cold)
        try:
            bad, bad_durs = mutate.corrupt(prog, durs, c.name, seed=7)
        except mutate.Ineligible:
            with pytest.raises(ref_mutate.Ineligible):
                ref_mutate.corrupt(rprog, rdurs, c.name, seed=7)
            continue
        rbad, rbad_durs = ref_mutate.corrupt(rprog, rdurs, c.name, seed=7)
        with pytest.raises(ref_diag.PlanCheckError) as ref_err:
            ref_verify.verify_program(rbad, durations=rbad_durs)
        with pytest.raises(PlanCheckError) as err:
            verify.verify_program(bad, durations=bad_durs,
                                  subject=f"{system}/{wname}")
        assert err.value.code == ref_err.value.code == c.code, (
            c.name, system, wname, cold)
        caught += 1
    assert caught, f"no eligible cell for corruption {c.name}"


def test_diagnostic_codes_equal_reference():
    codes = {n: getattr(diag, n) for n in dir(diag) if n.startswith("V_")}
    assert codes == {n: getattr(ref_diag, n) for n in dir(ref_diag)
                     if n.startswith("V_")}
    assert {c.code for c in ref_mutate.CORRUPTIONS} <= set(codes.values())


def test_verify_on_compile_verifies_every_new_program(monkeypatch):
    seen = []
    real = verify.verify_program
    monkeypatch.setattr(verify, "verify_program",
                        lambda prog, *a, **k: (seen.append(prog),
                                               real(prog, *a, **k))[1])
    prev = plan.set_verify_on_compile(True)
    try:
        assert plan.verify_on_compile()
        for system in SYSTEMS:
            for w in workloads.REGISTRY.values():
                plan.compile_program(plan.SYSTEMS[system], w.profile,
                                     cold=True)
        assert seen and all(p.names[-1] == "reply" for p in seen)
    finally:
        plan.set_verify_on_compile(prev)
        plan._compile_program.cache_clear()
    assert plan.verify_on_compile() is False


def test_overlay_opcodes_pinned_to_the_des():
    """PlanVerify keeps no copy of the opcodes it checks: they are the
    port DES's, which equal the reference DES's."""
    assert not hasattr(verify, "_OP_WIRE")
    assert not hasattr(verify, "_OP_CACHE")
    assert des._OP_WIRE == ref_des._OP_WIRE
    assert des._OP_CACHE == ref_des._OP_CACHE


def _overlay(system, wname, cold):
    spec = ref_plan.SYSTEMS[system]
    rw = ref_workloads.REGISTRY[wname]
    kb = TRANSPORTS[spec.transport].kernel_bypass
    prog, tmpl = ref_des._build_bundle(spec, rw, cold, kb)
    cops, cops2, acc = ref_des.cache_overlay(prog, tmpl[4], tmpl[5],
                                             rw.profile)
    return (prog, tmpl, cops, cops2, acc, rw.profile,
            workloads.REGISTRY[wname].profile)


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("wname", ["WEB", "SG", "PIPE"])
@pytest.mark.parametrize("system", ["nexus", "baseline", "wasm",
                                    "nexus-async"])
def test_des_overlays_verify_clean(system, wname, cold):
    prog, tmpl, cops, cops2, acc, rprof, prof = _overlay(system, wname, cold)
    ref_verify.verify_cache_overlay(prog, tmpl[4], tmpl[5], cops, cops2, acc,
                                    rprof)
    verify.verify_cache_overlay(_to_port(prog), tmpl[4], tmpl[5], cops,
                                cops2, acc, prof, subject=f"{system}/{wname}")


def test_overlay_corruptions_raise_the_reference_codes():
    prog, tmpl, cops, cops2, acc, rprof, prof = _overlay("nexus", "WEB",
                                                         False)
    bad = list(cops)
    bad[prog.names.index("compute[0]")] = ref_des._OP_CACHE
    cases = {
        "V-CACHE-WIRE": (tuple(bad), cops2, acc),
        "V-CACHE-COVER": (tmpl[4], cops2, acc),
        "V-CACHE-OP": (cops, cops2, acc[:-1]),
    }
    for code, (o, o2, a) in cases.items():
        for fn, p, P, err in (
                (ref_verify.verify_cache_overlay, prog, rprof,
                 ref_diag.PlanCheckError),
                (verify.verify_cache_overlay, _to_port(prog), prof,
                 PlanCheckError)):
            with pytest.raises(err) as e:
                fn(p, tmpl[4], tmpl[5], o, o2, a, P)
            assert e.value.code == code


def test_overlay_opcodes_read_from_the_port_s_des(monkeypatch):
    """The checker reads the opcodes from the port's `des` at each call:
    a clean overlay fails once the DES's cache opcode is moved."""
    prog, tmpl, cops, cops2, acc = _port_overlay(
        "nexus", workloads.REGISTRY["WEB"])(False)
    verify.verify_cache_overlay(prog, tmpl[4], tmpl[5], cops, cops2, acc,
                                workloads.REGISTRY["WEB"].profile)
    monkeypatch.setattr(des, "_OP_CACHE", des._OP_CACHE + 1000)
    with pytest.raises(PlanCheckError) as e:
        verify.verify_cache_overlay(prog, tmpl[4], tmpl[5], cops, cops2,
                                    acc, workloads.REGISTRY["WEB"].profile)
    assert e.value.code == "V-CACHE-WIRE"


def _port_overlay(system, w):
    """The port DES's bundle and cache overlay for one workload."""
    def build(cold):
        spec = plan.SYSTEMS[system]
        kb = PORT_TRANSPORTS[spec.transport].kernel_bypass
        prog, tmpl = des._build_bundle(spec, w, cold, kb)
        return (prog, tmpl,
                *des.cache_overlay(prog, tmpl[4], tmpl[5], w.profile))
    return build


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("system", SYSTEMS)
def test_port_des_overlays_equal_reference_and_verify_clean(system, cold):
    ref_profiles = _profiles(ref_workloads)
    for name, w in _profiles(workloads).items():
        prog, tmpl, cops, cops2, acc = _port_overlay(system, w)(cold)
        verify.verify_cache_overlay(prog, tmpl[4], tmpl[5], cops, cops2,
                                    acc, w.profile,
                                    subject=f"{system}/{name}")
        rw = ref_profiles[name]
        spec = ref_plan.SYSTEMS[system]
        rprog, rtmpl = ref_des._build_bundle(
            spec, rw, cold, TRANSPORTS[spec.transport].kernel_bypass)
        assert _fields(prog) == _fields(rprog), name
        assert (cops, cops2, acc) == ref_des.cache_overlay(
            rprog, rtmpl[4], rtmpl[5], rw.profile), name


def test_port_overlay_corruptions_raise_the_reference_codes():
    w = workloads.REGISTRY["WEB"]
    prog, tmpl, cops, cops2, acc = _port_overlay("nexus", w)(False)
    bad = list(cops)
    bad[prog.names.index("compute[0]")] = des._OP_CACHE
    cases = {
        "V-CACHE-WIRE": (tuple(bad), cops2, acc),
        "V-CACHE-COVER": (tmpl[4], cops2, acc),
        "V-CACHE-OP": (cops, cops2, acc[:-1]),
    }
    for code, (o, o2, a) in cases.items():
        with pytest.raises(PlanCheckError) as e:
            verify.verify_cache_overlay(prog, tmpl[4], tmpl[5], o, o2, a,
                                        w.profile)
        assert e.value.code == code
