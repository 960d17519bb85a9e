"""PlanCheck for the port: static analysis over handlers and compiled plans.

Copies of ``repro.core.analysis``'s two analyzers:

* `infer` — ProfileInfer: statically recovers a handler's ordered
  storage-call sequence from its AST and matches it against the
  declared `IOProfile` (`check_workload`);
* `verify` — PlanVerify: re-derives and checks every structural
  invariant of a lowered `PlanProgram` against its `PhasePlan` and
  variant rules (`verify_program`);

with their shared diagnostics (`diag`), plus `mutate` (the seeded
corruptor that mutation-tests the verifier) and `driver` (the exhaustive
variant × workload × coldness matrix run by
``python -m repro_torch.core.analysis``). The package exports what the
reference's exports.
"""
from .diag import Diagnostic, PlanCheckError, ProfileContractError
from .driver import MatrixReport, matrix_workloads, run_matrix
from .infer import InferenceResult, check_workload, infer_handler
from .verify import verify_plan, verify_program

__all__ = [
    "Diagnostic",
    "PlanCheckError",
    "ProfileContractError",
    "InferenceResult",
    "check_workload",
    "infer_handler",
    "verify_plan",
    "verify_program",
    "MatrixReport",
    "matrix_workloads",
    "run_matrix",
]
