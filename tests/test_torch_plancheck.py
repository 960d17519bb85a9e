"""The port's PlanCheck mutation suite and matrix driver
(`repro_torch.core.analysis.{mutate,driver}`) against the reference's
(`repro.core.analysis.{mutate,driver}`), in one process on the CPU.

* `CORRUPTIONS` equal the reference's in name, code and text;
* `corrupt` on the port's program gives the fields the reference's
  `corrupt` gives on the reference's program, for every corruption,
  seed, variant, registry workload, coldness and lowering, or raises
  `Ineligible` in both with the same reason;
* every corruption, applied by the port's `corrupt`, is caught by the
  port's `verify_program` with its own code on every eligible cell of
  the mutation matrix (`tests/test_plancheck.py`'s);
* `run_matrix()` gives the reference's `MatrixReport` and progress
  lines, and `main(["--quiet"])` (also run as
  ``python -m repro_torch.core.analysis``) returns 0 and prints the
  reference's summary line.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

from repro.core import plan as ref_plan
from repro.core import workloads as ref_workloads
from repro.core.analysis import driver as ref_driver
from repro.core.analysis import mutate as ref_mutate
from repro_torch.core import plan, workloads
from repro_torch.core.analysis import driver, mutate
from repro_torch.core.analysis import (MatrixReport, matrix_workloads,
                                       run_matrix, verify_program)
from repro_torch.core.analysis.diag import PlanCheckError
from repro_torch.core.transport import TRANSPORTS

SYSTEMS = list(plan.SYSTEMS)
SEEDS = (0, 7, 123)

#: `tests/test_plancheck.py::_MUTATION_CELLS`: the configs on which each
#: damage class must be caught with its own code
_MUTATION_CELLS = [
    ("nexus", "PIPE", True), ("nexus", "PIPE", False),
    ("nexus", "SG", True), ("nexus", "FAN", True),
    ("nexus-tcp", "PIPE", True), ("nexus-async", "PIPE", True),
    ("baseline", "PIPE", True), ("baseline", "AES", False),
]


def _cell(P, W, system, wname, cold, kb=None):
    spec = P.SYSTEMS[system]
    w = W.REGISTRY[wname]
    if kb is None:
        kb = TRANSPORTS[spec.transport].kernel_bypass
    prog = P.compile_program(spec, w.profile, cold, kernel_bypass=kb)
    return prog, P.duration_vector(spec, w, cold)


def _plan(pp):
    return (pp.system, pp.cold,
            tuple((p.name, p.resource, p.after, p.backend_group)
                  for p in pp.phases),
            pp.release_after, pp.respond_after)


def _fields(prog):
    """A program's init fields, its plan as plain tuples."""
    out = {f.name: getattr(prog, f.name)
           for f in dataclasses.fields(prog) if f.init and f.name != "plan"}
    out["plan"] = _plan(prog.plan)
    return out


def _mutated(mod, prog, durs, name, seed):
    try:
        bad, bad_durs = mod.corrupt(prog, durs, name, seed=seed)
    except mod.Ineligible as e:
        return ("ineligible", str(e))
    return (_fields(bad), bad_durs)


def test_corruptions_equal_reference():
    assert [(c.name, c.code, c.doc) for c in mutate.CORRUPTIONS] == \
        [(c.name, c.code, c.doc) for c in ref_mutate.CORRUPTIONS]
    assert list(mutate.BY_NAME) == list(ref_mutate.BY_NAME)
    assert len({c.code for c in mutate.CORRUPTIONS}) == \
        len(mutate.CORRUPTIONS)


@pytest.mark.parametrize("c", mutate.CORRUPTIONS, ids=lambda c: c.name)
def test_corrupt_equals_reference(c):
    """Every variant, registry workload, coldness, lowering and seed:
    the port's damage equals the reference's, field for field, or both
    find the program ineligible for the same reason."""
    eligible = 0
    for system in SYSTEMS:
        for wname in workloads.REGISTRY:
            for cold in (False, True):
                for kb in (False, True):
                    prog, durs = _cell(plan, workloads, system, wname,
                                       cold, kb)
                    rprog, rdurs = _cell(ref_plan, ref_workloads, system,
                                         wname, cold, kb)
                    assert _fields(prog) == _fields(rprog)
                    for seed in SEEDS:
                        got = _mutated(mutate, prog, durs, c.name, seed)
                        want = _mutated(ref_mutate, rprog, rdurs, c.name,
                                        seed)
                        assert got == want, (system, wname, cold, kb, seed)
                        eligible += got[0] != "ineligible"
    assert eligible, f"no eligible program for corruption {c.name}"


@pytest.mark.parametrize("c", mutate.CORRUPTIONS, ids=lambda c: c.name)
def test_corruption_caught_with_its_own_code(c):
    """The port's corruptor against the port's verifier: each damage
    class trips exactly its documented code on every eligible cell."""
    caught = 0
    for system, wname, cold in _MUTATION_CELLS:
        prog, durs = _cell(plan, workloads, system, wname, cold)
        try:
            bad, bad_durs = mutate.corrupt(prog, durs, c.name, seed=7)
        except mutate.Ineligible:
            continue
        with pytest.raises(PlanCheckError) as err:
            verify_program(bad, durations=bad_durs,
                           subject=f"{system}/{wname}")
        assert err.value.code == c.code, (c.name, system, wname, cold)
        caught += 1
    assert caught, f"no eligible cell for corruption {c.name}"


def test_matrix_workloads_equal_reference():
    got = [(s, w.name) for s, w in matrix_workloads()]
    assert got == [(s, w.name) for s, w in ref_driver.matrix_workloads()]
    assert len(got) == 25


def test_run_matrix_equals_reference():
    log, ref_log = [], []
    report = run_matrix(log=log.append)
    ref = ref_driver.run_matrix(log=ref_log.append)
    assert isinstance(report, MatrixReport)
    assert dataclasses.asdict(report) == dataclasses.asdict(ref)
    assert log == ref_log
    assert report.ok
    assert report.warnings == []
    assert report.handlers_checked >= len(workloads.REGISTRY)
    assert report.cells_verified == len(SYSTEMS) * len(matrix_workloads()) * 4


def test_main_quiet_prints_the_reference_summary(capsys):
    assert driver.main(["--quiet"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert ref_driver.main(["--quiet"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert got == want
    assert got[-1] == ("plancheck: 25 handlers, 700 plan/program cells, "
                       "0 warnings, 0 failures")


def test_module_entry_point_runs_main():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.analysis", "--quiet"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("plancheck: 25 handlers")
    assert "jax" not in out.stderr
