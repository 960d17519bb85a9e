"""Shared PlanCheck diagnostics.

Both analyzers — `infer.ProfileInfer` (handler <-> IOProfile) and
`verify.PlanVerify` (PhasePlan/PlanProgram invariants) — and the
runtime's profile-contract observer report through one error type, so a
failure looks the same whether it was caught at registration time, at
compile time, or mid-invocation: a stable machine-checkable ``code``, a
human message, and where applicable the op index and handler source
location.

Codes are namespaced:

* ``PC-*`` — ProfileInfer findings (handler-side static analysis);
* ``V-*``  — PlanVerify findings (plan/program structural invariants).

A copy of ``repro.core.analysis.diag``, whole.
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

# ----------------------------------------------------- PlanVerify codes

V_PLAN = "V-PLAN"                  # plan-level structural defect
V_TRED = "V-TRED"                  # edge implied by another path
V_TOPO = "V-TOPO"                  # cycle / non-topological index order
V_EDGE = "V-EDGE"                  # pred/succ asymmetry
V_CSR = "V-CSR"                    # succ_flat/succ_off vs succ rows
V_INDEGREE = "V-INDEGREE"          # indegree != len(pred)
V_ROOTS = "V-ROOTS"                # roots != zero-indegree set
V_XEDGE = "V-XEDGE"                # program edges != plan edges
V_XNAME = "V-XNAME"                # program names != plan phases
V_XCORE = "V-XCORE"                # on_core mask != resource tags
V_SLOT = "V-SLOT"                  # acquire/release unbalanced
V_SLOT_HEAD = "V-SLOT-HEAD"        # slot acquired off the group head
V_SLOT_REL = "V-SLOT-REL"          # release at the wrong member for
                                   # the transport's kernel-bypass rule
V_BARRIER_RESPOND = "V-BARRIER-RESPOND"  # respond barrier not the reply
V_BARRIER_PUTGATE = "V-BARRIER-PUTGATE"  # a durable PUT escapes the reply
V_BARRIER_RELEASE = "V-BARRIER-RELEASE"  # release predates the restore
V_BARRIER_ASYNC = "V-BARRIER-ASYNC"      # async write chain blocks a
                                         # guest phase
V_FABRIC = "V-FABRIC"              # fabric mask != fetch/write chains
V_BGROUP = "V-BGROUP"              # bgroup_of/head/members inconsistent
V_PUTORD = "V-PUTORD"              # put_ordinal != write_net ordinal
V_RESTORE = "V-RESTORE"            # restore_idx mislowered
V_GROUPS = "V-GROUPS"              # breakdown-group arrays inconsistent
V_DUR = "V-DUR"                    # duration vector misaligned
V_CACHE_OP = "V-CACHE-OP"          # cache access list != profile
V_CACHE_WIRE = "V-CACHE-WIRE"      # illegal cache-opcode patch position
V_CACHE_COVER = "V-CACHE-COVER"    # cacheable GET wire left unpatched


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
