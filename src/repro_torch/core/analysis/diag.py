"""Shared PlanCheck diagnostics.

`infer.ProfileInfer` (handler <-> IOProfile) and the runtime's
profile-contract observer report through one error type, so a failure
looks the same whether it was caught at registration time or
mid-invocation: a stable machine-checkable ``code``, a human message,
and where applicable the op index and handler source location.

A copy of ``repro.core.analysis.diag`` holding the ``PC-*`` codes
(ProfileInfer findings). The ``V-*`` codes belong to PlanVerify
(``analysis/verify.py``), which the port has not copied yet.
"""
from __future__ import annotations

from dataclasses import dataclass

# --------------------------------------------------- ProfileInfer codes

PC_SHAPE = "PC-SHAPE"              # inferred I/O sequence != declared
PC_DUP_KEY = "PC-DUP-KEY"          # two PUTs resolve to one (bucket, key)
PC_COND_GET = "PC-COND-GET"        # GET under a conditional branch
PC_COND_PUT = "PC-COND-PUT"        # PUT under a conditional branch
PC_TRY_IO = "PC-TRY-IO"            # I/O inside a try body (warn)
PC_EXCEPT_IO = "PC-EXCEPT-IO"      # I/O inside except/finally recovery
PC_LOOP = "PC-LOOP"                # I/O in a loop of unknown trip count
PC_ESCAPE = "PC-ESCAPE"            # ctx / storage reference escapes
PC_METHOD = "PC-METHOD"            # unknown method on the storage surface
PC_TRAILING_GET = "PC-TRAILING-GET"  # GET after the final compute (warn)
PC_NO_SOURCE = "PC-NO-SOURCE"      # handler source unavailable (warn)
PC_CONTRACT = "PC-CONTRACT"        # runtime observation diverged

class PlanCheckError(RuntimeError):
    """A static-analysis finding severe enough to reject the artifact.

    ``code`` is one of the module-level constants; ``subject`` names
    what was being checked (workload or ``system/coldness`` cell);
    ``op_index``/``line`` locate the finding when they apply.
    """

    def __init__(self, code: str, message: str, *, subject: str = "",
                 op_index: int | None = None, line: int | None = None):
        self.code = code
        self.subject = subject
        self.op_index = op_index
        self.line = line
        where = f"{subject}: " if subject else ""
        super().__init__(f"[{code}] {where}{message}")


class ProfileContractError(PlanCheckError):
    """Runtime divergence between a handler's observed storage calls
    and its declared IOProfile — the dynamic counterpart of `PC_SHAPE`,
    raised by `runtime._GuestRun` with the same precision the static
    analyzer gives (op index, expected vs observed, source line)."""


@dataclass(frozen=True)
class Diagnostic:
    """One non-fatal (or collected) analyzer finding."""

    code: str
    severity: str                 # 'error' | 'warn'
    message: str
    line: int | None = None
    op_index: int | None = None

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def __str__(self) -> str:
        loc = f" (line {self.line})" if self.line is not None else ""
        return f"[{self.code}] {self.message}{loc}"
