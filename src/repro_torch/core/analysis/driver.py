"""PlanCheck driver: the exhaustive matrix run behind
``python -m repro_torch.core.analysis``.

Checks every handler in ``REGISTRY`` ∪ ``chaos_suite()`` ∪
``ml_suite()`` (both scales) against its declared `IOProfile` with
`infer.check_workload`, then verifies every compiled plan/program over
the full (variant × workload × coldness) matrix — both kernel-bypass
lowerings, each against its aligned duration vector — with
`verify.verify_program`. CI runs this alongside the golden-drift gate;
a structural regression in the lowering fails the build even when no
behavioral test happens to walk the damaged arrays.

A copy of ``repro.core.analysis.driver``, whole, over the port's
``plan``, ``transport`` and ``workloads``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.plan import SYSTEMS, compile_program, duration_vector
from repro_torch.core.transport import TRANSPORTS
from repro_torch.core.workloads import (REGISTRY, Workload, chaos_suite,
                                        ml_suite)

from .diag import PlanCheckError
from .infer import check_workload
from .verify import verify_program


def matrix_workloads() -> list[tuple[str, Workload]]:
    """The full deployment surface: paper suite + multi-I/O scenarios,
    chaos mix, and both MLServe scales (same shapes, distinct sizes —
    the duration vectors differ even where the plans are shared)."""
    out: list[tuple[str, Workload]] = []
    out.extend(("registry", w) for w in REGISTRY.values())
    out.extend(("chaos", w) for w in chaos_suite().values())
    for scale in ("full", "tiny"):
        out.extend((f"ml-{scale}", w) for w in ml_suite(scale).values())
    return out


@dataclass
class MatrixReport:
    handlers_checked: int = 0
    cells_verified: int = 0
    warnings: list[str] = field(default_factory=list)
    failures: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def run_matrix(*, fail_fast: bool = False,
               log=lambda msg: None) -> MatrixReport:
    """Infer + match every handler, then verify every (variant ×
    workload × coldness × kernel-bypass) plan/program cell."""
    report = MatrixReport()
    pairs = matrix_workloads()

    for suite, w in pairs:
        try:
            res = check_workload(w)
        except PlanCheckError as e:
            report.failures.append(f"{suite}/{w.name}: {e}")
            if fail_fast:
                raise
            continue
        report.handlers_checked += 1
        for warn in res.warnings:
            report.warnings.append(f"{suite}/{w.name}: {warn}")
    log(f"handlers: {report.handlers_checked} inferred and matched, "
        f"{len(report.warnings)} warnings")

    for spec in SYSTEMS.values():
        native_kb = TRANSPORTS[spec.transport].kernel_bypass
        for suite, w in pairs:
            for cold in (False, True):
                durs = duration_vector(spec, w, cold)
                # both lowerings: the transport's native rule plus the
                # alternate, so a rule regression can't hide behind the
                # variant that doesn't exercise it.
                for kb in (native_kb, not native_kb):
                    cell = (f"{spec.name}/{suite}/{w.name}/"
                            f"{'cold' if cold else 'warm'}/kb={kb}")
                    try:
                        prog = compile_program(spec, w.profile, cold,
                                               kernel_bypass=kb)
                        verify_program(prog, durations=durs,
                                       subject=cell)
                    except PlanCheckError as e:
                        report.failures.append(str(e))
                        if fail_fast:
                            raise
                        continue
                    report.cells_verified += 1
        log(f"{spec.name}: verified")
    log(f"cells: {report.cells_verified} verified, "
        f"{len(report.failures)} failures")
    return report


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.core.analysis",
        description="PlanCheck: static handler I/O inference + "
                    "plan/program invariant verification")
    ap.add_argument("--all", action="store_true",
                    help="run the exhaustive matrix (default behavior; "
                         "kept for CI-invocation clarity)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress lines")
    args = ap.parse_args(argv)

    log = (lambda msg: None) if args.quiet else print
    report = run_matrix(log=log)
    for warn in report.warnings:
        print(f"warn: {warn}")
    for failure in report.failures:
        print(f"FAIL: {failure}")
    print(f"plancheck: {report.handlers_checked} handlers, "
          f"{report.cells_verified} plan/program cells, "
          f"{len(report.warnings)} warnings, "
          f"{len(report.failures)} failures")
    return 0 if report.ok else 1
